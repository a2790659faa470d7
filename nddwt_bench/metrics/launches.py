"""The program's own launch counter (``cuda_kernels.launch_counts``, every
hand-written kernel), summed over the window, a step."""


def read(rec):
    if not rec.steps or rec.launches is None:
        return None
    return sum(rec.launches.values()) / rec.steps
