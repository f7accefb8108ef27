"""device_idle.svd (%): the share of the traced stretch (the service's closed
loop under the profiler) in which no operation ran on the card."""

from perfbench.harness.trace import idle_share as read  # noqa: F401
