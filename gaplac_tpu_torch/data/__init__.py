from gaplac_tpu_torch.data.grid import make_test_df, make_test_grid
from gaplac_tpu_torch.data.io import complete_cases, df_output, load_tables, read_table
from gaplac_tpu_torch.data.transforms import getrank, invnormaltransform
