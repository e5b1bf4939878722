"""The whole model step's share of the chip's peak, in percent: the model
operations of the traced window's work (counted on the benchmark's reference
model, ``core/roofline.py::model_flops``) over the window's time and the
peak of the cell's dtype (``core/roofline.py::PEAK_FLOPS``)."""


def read(run):
    if not run.units:
        return None
    return 100.0 * run.flops() / run.window_s / run.peak_flops
