"""The port's benchmark: cells of the device-resident design-space
exploration, driven by ``BENCHMARK.json`` (run with ``portbench/run.py``)."""
