from gaplac_tpu_torch.dsl.ast import (
    Cat, Constant, GPComponent, GPOperation, Leaf, Linear, Matern32, Matern52,
    Noise, OU, Periodic, RQ, SqExp, leaves, sum_of_products,
)
from gaplac_tpu_torch.dsl.parser import (
    FormulaError, LikelihoodSpec, Spec, parse_formula, parse_kernel_expr,
    parse_likelihood, GAUSSIAN,
)
from gaplac_tpu_torch.dsl.ranges import (
    RangeError, build_at_frame, default_range, parse_at_ranges,
)
