"""The cell-independent part of the benchmark: the manifest and its files, the
device checks, the profiler's trace and its reduction, the result line."""
