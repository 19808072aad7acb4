"""The rot6d cell (``gen_rot6d_bf16_500x1000``) and what it adds beside the
accepted cells: the four accepted cells resolve as before it, the new cell
resolves to its metrics, its rooflines' arithmetic by hand, and at a tiny
size on the CPU its run comes out correct and its faults not correct."""
import time

import pytest
import torch

from portbench import harness
from portbench.roofline import k1pre, k2w
from portbench.tests import tiny

REPO = tiny.REPO
NEW = "gen_rot6d_bf16_500x1000"
GEN = ["call_device_ms.gen", "mfu.gen", "k1_roofline.gen", "k2_roofline.gen",
       "device_idle_pct.gen", "replay_device_ms.gen", "loop_idle_pct.gen", "graph_hit_pct.gen",
       "build_s.gen"]
# each accepted cell as the benchmark resolved it before the rot6d cell:
# (configuration, traffic, end-to-end metrics, per-layer metrics)
ACCEPTED = {
    "gen_bf16_500x1000": ("dposer_subvp_bf16", "gen_500x1000", ["poses_per_s", "setup_s"], GEN),
    "comp_bf16_100x10": (
        "dposer_subvp_bf16", "comp_100x10", ["request_p95_ms", "setup_s"],
        ["solve_host_ms.comp", "mfu.comp", "k1_roofline.comp", "k6_roofline.comp",
         "device_idle_pct.comp", "task_self_ms.comp", "replay_device_ms.comp",
         "loop_idle_pct.comp", "graph_hit_pct.comp", "build_s.comp"]),
    "train_bf16_b1280": (
        "dposer_subvp_bf16", "train_b1280", ["train_step_device_ms", "setup_s"],
        ["samples_per_s.train", "step_host_ms.train", "mfu.train", "k10_roofline.train",
         "k12_roofline.train", "device_idle_pct.train", "fwd_host_ms.train",
         "bwd_host_ms.train", "update_host_ms.train", "build_s.train"]),
    "gen_int8ch_500x1000": (
        "dposer_subvp_int8ch", "gen_500x1000", ["poses_per_s", "setup_s"],
        [m for m in GEN if m not in ("k1_roofline.gen", "k2_roofline.gen")][:2]
        + ["k2_roofline.gen", "k13_roofline.gen"]
        + [m for m in GEN if m not in ("k1_roofline.gen", "k2_roofline.gen")][2:]),
}


def resolved(workload):
    spec = harness.cell_spec(REPO, workload)
    return (spec.cell["config"], spec.cell["traffic"], [m["name"] for m in spec.end_to_end],
            [m["name"] for m in spec.per_layer])


@pytest.mark.parametrize("workload", list(ACCEPTED))
def test_accepted_cells_resolve_as_before(workload):
    assert resolved(workload) == ACCEPTED[workload]


def test_rot6d_cell_resolves_to_its_metrics():
    spec = harness.cell_spec(REPO, NEW)
    assert spec.cell["chips"] == 1 and spec.cell["traffic"] == "gen_500x1000"
    m = spec.config["model"]
    assert (m["n_poses"], m["pose_dim"], m["hidden_dim"], m["embed_dim"], m["n_blocks"]) == (
        21, 6, 1024, 512, 2)
    assert spec.config["reduced"] == [] and spec.config["data"]["rot_rep"] == "rot6d"
    assert resolved(NEW)[2:] == (
        ["poses_per_s", "setup_s"],
        [n for n in GEN if n != "k2_roofline.gen"]
        + ["k1pre_roofline.gen6", "k2w_roofline.gen6", "wide_route_pct.gen6"])
    assert set(spec.limits) == {"step_gap_max", "step_gap_rms"}


def test_rooflines_by_hand():
    """At 500 rows, H 1024, D 126: both kernels are bound by bytes."""
    rows, h, d = 500, 1024, 126
    # K1's pre route: x 252,000 B, W0 258,048, three rows 12,288, out 2,048,000, copy 1,024,000
    pre_bytes = 252_000 + 258_048 + 12_288 + 2_048_000 + 1_024_000
    assert k1pre.layer_s(rows, d, h) == pytest.approx(pre_bytes / 3.35e12)
    assert 2 * rows * d * h / 989e12 < pre_bytes / 3.35e12
    # K2 at 128 columns: h 2,048,000, Wpost 262,144, bias 512, x in and out 504,000, 32
    head_bytes = 2_048_000 + 262_144 + 512 + 504_000 + 32
    assert k2w.head_s(rows, h, d) == pytest.approx(head_bytes / 3.35e12)
    work = dict(rows=rows, hidden=h, dim=d, n_blocks=2, forwards=1000, em_heads=1000)
    assert k1pre.bound_s(work) == pytest.approx(1000 * pre_bytes / 3.35e12)
    assert k2w.bound_s(work) == pytest.approx(1000 * head_bytes / 3.35e12)
    assert k1pre.bound_s(work) * 1e3 == pytest.approx(1.0729, abs=1e-4)  # ms a call
    assert k2w.bound_s(work) * 1e3 == pytest.approx(0.8402, abs=1e-4)


def test_patterns_name_the_new_instantiations():
    import re

    assert re.search(k1pre.PATTERN, "void pre::dense_gn_silu_kernel<32, 2>(float const*)")
    assert not re.search(k1pre.PATTERN, "void handoff::dense_gn_silu_wgmma_kernel<32>()")
    for name in ("head_em_wide_kernel(float const*)", "head_em_impute_wide_kernel(float)"):
        assert re.search(k2w.PATTERN, "void (anonymous namespace)::" + name)
    assert not re.search(k2w.PATTERN, "void (anonymous namespace)::head_em_kernel(float)")


def run(root, **kw):
    return harness.run(root, NEW, 2 ** 33 + 11, 0.2, False, time.perf_counter(), device="cpu",
                       err=open("/dev/null", "w"), **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny6"))


def test_rot6d_run_is_correct(root):
    res = run(root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"poses_per_s", "setup_s"}


def test_head_truncated_to_64_columns_is_caught(root, monkeypatch):
    """The program's head cut to its first 64 columns (the last 62 dims get
    no model term): not correct."""
    from dposer_tpu_torch.ops.cuda import fused_em

    real = fused_em.build_sampler_operands

    def truncated(*a, **kw):
        net, coefs = real(*a, **kw)
        net["w_post"][:, 64:] = 0
        net["b_post"][64:] = 0
        return net, coefs

    monkeypatch.setattr(fused_em, "build_sampler_operands", truncated)
    res = run(root)
    assert not res["correct"], res["checks"]


def test_normals_at_another_column_stride_are_caught(root, monkeypatch):
    """The reference's normals laid out at a row stride of 128 columns in
    place of 126 (as a kernel keying columns by the padded width would draw
    them): not correct."""
    from portbench.drivers import generation

    real = generation.Cell._normals

    def strided(self, i):
        good = real(self, i)

        def normals(step):
            z = good(step)
            flat = torch.zeros(z.shape[0] * 128, dtype=z.dtype, device=z.device)
            flat[:z.numel()] = z.reshape(-1)
            return flat.view(z.shape[0], 128)[:, :z.shape[1]].contiguous()

        return normals

    monkeypatch.setattr(generation.Cell, "_normals", strided)
    res = run(root)
    assert not res["correct"], res["checks"]
