"""device_idle.train (%): the share of the traced stretch (training steps
under the profiler) in which no operation ran on the card."""

from perfbench.harness.trace import idle_share as read  # noqa: F401
