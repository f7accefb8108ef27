"""svd.admit_us (us): host time inside ``ContinuousBatcher.admit`` (which
queues into ``SvdService.enqueue``), over every admit of the traced window,
over their count."""


def read(rec):
    return rec.get("admit_us")
