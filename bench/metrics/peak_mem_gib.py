"""Peak device memory the program allocated during the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
read by the harness on the host."""

UNIT = "GiB"
SOURCE = "host_clock"


def read(r):
    return r.peak_bytes / 2**30
