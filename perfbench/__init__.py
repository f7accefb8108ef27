"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on an NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run, with its source,
  the keys ``reduced`` from it, the sizes ``assumed`` and the ``departures``;
* ``traffic/<traffic>.json``: the driver that generates the traffic and its
  parameters (one general generator a driver, ``drivers/<driver>.py``);
* ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings each was set from;
* ``layer_metrics/<metric>.py``: the reader of one per-layer metric.

``counts/`` holds the frozen operation and byte counts and the card's peaks,
``reference/`` the plain references, ``inputs/`` the seeded inputs both the
program and the reference are given.  Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of ``repro_torch``.
"""
