"""The metrics (counterpart of ``vdiff_tpu/metrics``): FID (streaming
Inception statistics and the Fréchet distance), the Inception Score and
improved Precision/Recall, their feature nets on the device. See fid.py,
inception.py, inception_score.py, precision_recall.py and vgg.py."""

from .fid import InceptionStatistics, calc_fd, get_precomputed

__all__ = ["InceptionStatistics", "get_precomputed", "calc_fd"]
