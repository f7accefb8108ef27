"""Launchers, in PyTorch: the production mesh (``launch.mesh``), the
roofline's counts and the H100's peaks (``launch.roofline``), the dry-run on
the meta device (``launch.dryrun``), its report (``launch.report``) and the
hill-climb driver (``launch.perf_iter``).

Counterpart of ``repro.launch``.  Importing it touches no card.
"""
