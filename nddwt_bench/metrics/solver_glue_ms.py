"""Device time a step (a FISTA iteration) of every operation that is not
one of the program's own kernels (``tracing.is_program_kernel``: the
kernels its CUDA and Triton sources define): cuFFT and PyTorch's
elementwise and copy kernels of the data term, the momentum and the complex
split and join, from the traced window, in ms."""

from nddwt_bench.tracing import is_program_kernel


def read(rec):
    if rec.trace is None or not rec.trace.by_name or not rec.steps:
        return None
    glue = sum(s for name, s in rec.trace.by_name.items()
               if not is_program_kernel(name, rec.program_kernels))
    return 1e3 * glue / rec.steps
