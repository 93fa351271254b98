"""``mfu`` in the cells whose end-to-end metric is ``device_ms_per_step``
(BENCHMARK.json: each metric names the one it moves). The host-clock
reading of the traced window, where the loader's pace spreads too widely
from run to run for a bound."""

from perfbench.harness import reader

read = reader("mfu").read
