"""``loader_in_place_share`` in the cells whose end-to-end metric is ``device_ms_per_step``
(BENCHMARK.json: each metric names the one it moves)."""

from perfbench.harness import reader

read = reader("loader_in_place_share").read
