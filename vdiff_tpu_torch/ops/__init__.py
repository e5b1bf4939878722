"""The port's operations. Every wrapper of a hand-written kernel counts its
launches in its ``.launches``; :func:`launch_counts` reads them all."""

import importlib

#: every kernel wrapper that counts its launches, by module
COUNTED = {
    "attention": ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train", "attn_bwd",
                  "attn_bwd_rows", "attn_bwd_cols", "attn_fwd_tc", "attn_bwd_tc",
                  "attn_fwd_pack1", "attn_fwd_pack1_lse", "attn_bwd_pack1",
                  "attn_bwd_pack1_kv"),
    "groupnorm": ("gn_film_silu_kernel",),
    "conv3x3": ("fused_gn_silu_conv3x3",),
}


def counted_wrappers() -> dict:
    """Every counted kernel wrapper by name."""
    return {name: getattr(importlib.import_module(f"{__name__}.{module}"), name)
            for module, names in COUNTED.items() for name in names}


def launch_counts() -> dict:
    """Every counted wrapper's launches so far, by name."""
    return {name: fn.launches for name, fn in counted_wrappers().items()}
