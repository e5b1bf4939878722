"""Dataset registry (``DATA_INFO``, copied from ``vdiff_tpu/data.py``).

The loaders are not ported yet; the sampler needs only the registry.
"""

#: dataset registry (reference datasets.py:96-151)
DATA_INFO = {
    "mnist": {
        "num_classes": 10,
        "resolution": (32, 32),
        "channels": 1,
        "train_size": 60000,
        "test_size": 10000,
        "target_shift": 1,  # reserve 0 for the CFG null class
    },
    "cifar10": {
        "num_classes": 10,
        "resolution": (32, 32),
        "channels": 3,
        "train_size": 50000,
        "test_size": 10000,
        "random_flip": True,
        "target_shift": 1,
    },
    "celeba": {
        "num_classes": 40,
        "multitags": True,
        "resolution": (64, 64),
        "channels": 3,
        "train": 162770,
        "test": 19962,
        "validation": 19867,
        "random_flip": True,
    },
    "synthetic": {  # deterministic stand-in for tests / offline smoke runs
        "num_classes": 10,
        "resolution": (32, 32),
        "channels": 3,
        "train_size": 512,
        "test_size": 128,
        "target_shift": 1,
    },
}
