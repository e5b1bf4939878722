"""vdiff_tpu_torch.bench at its CPU miniature (``--device cpu``), in process:
the root bench's lines in its order, each a JSON object with a positive
value; and the FLOP count behind ``model_tf_per_sec``, which must include
the attention matmuls that the hand kernels hide from FlopCounterMode."""

import json

import torch

pytest_plugins = ["torch_limits"]

ROOT_METRICS = [  # the root bench.py's metric names, in its order
    "session_canary_matmul_tf_per_sec",
    "cifar10_train_img_per_sec_per_chip_bf16",
    "celeba_samples_per_sec_per_chip_ddim256",
    "celeba_train_img_per_sec_per_chip",
    "cifar10_samples_per_sec_per_chip_ddim256_cfg0.1",
    "cifar10_samples_per_sec_per_chip_ddim256",
]
ARMS = ["celeba_samples_per_sec_per_chip_ddim256_fused_gn",
        "cifar10_samples_per_sec_per_chip_ddim256_eager",
        "cifar10_samples_per_sec_per_chip_ddim256_fused_gn"]


def test_bench_cpu_miniature_prints_the_root_lines(capsys):
    from vdiff_tpu_torch import bench

    returned = bench.main(["--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    metrics = [line["metric"] for line in lines]
    assert not [m for m in metrics if m.endswith("_error")], lines
    assert metrics[0] == "session_canary_matmul_tf_per_sec"
    assert metrics[-1] == "cifar10_samples_per_sec_per_chip_ddim256"
    assert sorted(metrics) == sorted(ROOT_METRICS + ARMS)  # each once
    assert [m for m in metrics if m in ROOT_METRICS] == ROOT_METRICS
    assert lines == returned
    for line in lines:
        # unrounded: a CPU rate reads well under 1
        assert line["value"] > 0 and line["device"] == "cpu", line
        assert "mfu" not in line
        if line["metric"] != ROOT_METRICS[0]:
            assert line["model_tf_per_sec"] > 0, line
        if "samples" in line["metric"]:
            assert line["graph"] is False and set(line["switches"]) == set(bench.SWITCHES)
    by = {line["metric"]: line for line in lines}
    assert by["cifar10_samples_per_sec_per_chip_ddim256_cfg0.1"]["vs_baseline_est"] > 0
    assert by[ARMS[1]]["arm"] == "eager"
    assert by[ARMS[2]]["switches"]["VDIFF_FUSED_GN"] == "1"
    assert by[ROOT_METRICS[-1]]["switches"]["VDIFF_FUSED_GN"] == "0"


def test_flop_count_covers_the_attention_matmuls(monkeypatch):
    """The miniature flagship's count at batch 1 is its attention twins'
    4·B·N·T²·C at every call (q·kᵀ and P·v) plus the rest; a train step
    (loss and backward) counts more than twice the forward."""
    from vdiff_tpu_torch import bench
    from vdiff_tpu_torch.ops import attention as A

    model_kwargs, diffusion = bench._flagship(bench.Bench(torch.device("cpu")))
    calls = []
    twin = A.attention_qkv_reference

    def recording(qkv, num_heads):
        calls.append(tuple(qkv.shape))
        return twin(qkv, num_heads)

    monkeypatch.setattr(A, "attention_qkv_reference", recording)
    total = bench.flops_per_sample(model_kwargs, 32, ())
    attention = sum(4 * B * T * T * (three_nc // 3) for B, T, three_nc in calls)
    assert {T for _, T, _ in calls} == {64, 256, 1024}  # the flagship's three token counts
    monkeypatch.setattr(A, "attention_qkv_reference",
                        lambda qkv, n: qkv[..., : qkv.shape[-1] // 3].clone())  # no matmul
    assert total - bench.flops_per_sample(model_kwargs, 32, ()) == attention > 0
    monkeypatch.setattr(A, "attention_qkv_reference", twin)
    train = bench.flops_per_sample(model_kwargs, 32, (), train_diffusion=diffusion)
    assert train > 2 * total
