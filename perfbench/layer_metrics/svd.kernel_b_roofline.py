"""svd.kernel_b_roofline (%): kernel B's least time over its device time in
the traced stretch.  Each launch updates ``kernel_b_batch`` states (every
round of the closed loop takes every stream); an update's least
time is the larger of its operations over the card's float64 peak and its
bytes over the HBM bandwidth (``counts.kernel_b``: each state and pair byte
read once and written once); at the cell's shapes the bytes bind.  None when
no launch of the kernel is in the trace."""

from perfbench.counts import kernel_b, peaks

KERNEL = "fused_update_truncated_kernel"


def read(rec):
    red, shape = rec.get("trace"), rec.get("shape")
    if not red or not shape:
        return None
    names = [name for name in red["device_ops"] if KERNEL in name]
    device_s = sum(red["device_ops"][name] for name in names)
    launches = sum(red["launches"][name] for name in names)
    if device_s <= 0:
        return None
    least, _ = kernel_b.least_seconds(shape["m"], shape["n"], shape["r"], shape["itemsize"],
                                      peaks.F64_FLOPS, peaks.HBM_BYTES_PER_S)
    return 100.0 * least * launches * rec["kernel_b_batch"] / device_s
