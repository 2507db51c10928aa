"""Share of its roofline that kernel 1 (``quilt_prng_descent_lookup``,
``csrc/quilt_prng_descent_lookup.cu``) reaches: the frozen count's least
time for the rows and table shapes of every launch in the traced window,
over the device time of the kernel's launches in the trace.  Nothing to
read where no launch of the kernel was traced."""

from bench.harness import roofline

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "edges_per_s"
KERNEL = "quilt_prng_kernel"  # the CUDA function's name in the trace


def read(r):
    device_s = r.trace.time_of(KERNEL)
    if not r.launches or device_s <= 0:
        return None
    bound_ms = sum(roofline.lookup_bound_ms(**launch) for launch in r.launches)
    return 100.0 * bound_ms / (device_s * 1e3)
