"""train.span.trackers_ms (ms): the device ms of the program's span ``trackers``
(``optim.spectral_adam``'s call of ``spectral_update_basis_grouped``: the
trackers' rank-1 SVD updates), the mean over the program stretch's steps
(``harness.program_stretch``)."""

from perfbench.harness.program_stretch import span_ms


def read(rec):
    return span_ms(rec, "trackers")
