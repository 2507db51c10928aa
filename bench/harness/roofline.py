"""The yardstick's peaks and operation counts, frozen here so that a change
to the program cannot move them.

Peaks of one NVIDIA H100 SXM (data sheet, SXM5 column): HBM at 3.35 TB/s;
32-bit integer operations at 128 lanes per SM x 132 SMs x 1.98 GHz.  The
count of ``quilt_prng_descent_lookup`` is the one the port's
``analysis/roofline.py::kernel_bound_ms`` held on the day this benchmark
was written (``bench/tests`` holds the two equal at the cells' shapes):
per row, a level's counter hash 20, the uniform 3, the quadrant compares 5,
the bit updates 5 and loop control 2 (35 a level), a search step 10 twice,
and 80 for the row and block decode and the stores; bytes are the 16 of
output per row, the tables read once, 4 per graph id and 16 per level.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
EDGE_BYTES = 16  # an edge delivered as two int64 node ids


def lookup_bound_ms(rows: int, d: int, table_rows: int, table_width: int, num_graphs: int) -> float:
    """Least ms of one ``quilt_prng_descent_lookup`` launch over ``rows``
    candidate rows with (table_rows, table_width) lookup tables and
    ``num_graphs`` block pairs: the larger of its operations at the int32
    peak and its bytes at the HBM rate."""
    steps = max(table_width - 1, 1).bit_length() + 1
    ops = rows * (35 * d + 2 * 10 * steps + 80)
    nbytes = rows * 16 + table_rows * table_width * 8 + num_graphs * 4 + d * 16
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def call_bound_ms(rows: int, d: int, table_rows: int, table_width: int, num_graphs: int, edges: float) -> float:
    """Least ms of one sampler call: every candidate row through the descent
    and lookup (counted as above), and every delivered edge written once."""
    return lookup_bound_ms(rows, d, table_rows, table_width, num_graphs) + edges * EDGE_BYTES / HBM_BYTES_PER_S * 1e3
