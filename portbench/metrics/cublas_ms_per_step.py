"""``cublas_ms_per_step``: device time of cuBLAS's and CUTLASS's kernels
(products, triangular solves) per batched leapfrog."""

#: the libraries' kernel names: GEMM and GEMV in their SIMT, CUTLASS and
#: tensor-core forms, TRSM and TRSV, SYRK, and cuBLAS's level-1 kernels
PATTERN = (r"(?i)gemm|gemv|trsm|trsv|cutlass|xmma|syrk|herk|cublas|"
           r"dot_kernel|nrm2|scal_kernel|axpy|ger_kernel")


def read(ctx):
    seconds, count = ctx.trace.kernel_seconds(PATTERN)
    if not count or not ctx.calls:
        return None
    return 1e3 * seconds / ctx.calls
