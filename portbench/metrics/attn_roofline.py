"""The attention kernels' share of their roofline, in percent: the least
time of the traced window's attention calls (each the larger of its
operations over the dtype's peak and its bytes over HBM bandwidth,
``core/roofline.py::attention_least_s``, on the reference model's shapes)
over the device time of the kernels named below."""

#: substrings of the device kernel names of the program's attention kernels
KERNELS = ("attn_fwd", "attn_bwd")


def read(run):
    if not run.units:
        return None
    spent = run.trace.device_time_s(lambda name: any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    return 100.0 * run.attention_least_s() / spent
