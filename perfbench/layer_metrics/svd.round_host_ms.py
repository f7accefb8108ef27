"""svd.round_host_ms (ms): host time of every ``pump`` of the traced window
that sealed rounds (``SvdService._flush_round``: stack, copy, dispatch, reap
of the oldest), over the rounds sealed."""


def read(rec):
    return rec.get("round_host_ms")
