"""The sampling chains' programmatic dependent launch, checked in the sources.

The kernels that the generation and completion graphs chain (K1, K2, K5,
K6, K13) are launched with programmatic stream serialization
(``csrc/mbarrier.cuh``): each may start while the launch before it still
runs, so each must wait for it (``grid_dependency_wait``, or a loop built
with the ``Programmatic`` tag, which waits) before it reads what an earlier
launch wrote. A kernel launched so without its wait would race. These tests
read the CUDA sources on the CPU: every kernel of the list waits, every
launch of the list sets the attribute, a kernel added to those files later
without its wait fails here, and the train step's kernels (K10-K12) keep
their plain launches.
"""
import re
from pathlib import Path

import pytest

from dposer_tpu_torch.ops.cuda import fused_em

CSRC = Path(__file__).resolve().parents[1] / "dposer_tpu_torch" / "ops" / "cuda" / "csrc"

# (file, function): the kernels of the chains, or the device function whose
# body each kernel is, that must wait for the launches before them
WAITING = [
    ("dense_gn_silu.cu", "dense_gn_silu_kernel"),  # K1's pre route
    ("dense_gn_silu.cu", "dense_gn_silu_wgmma_kernel"),  # K1 from the bf16 copy
    ("dense_gn_silu_int8.cu", "dense_gn_silu_int8_kernel"),  # K13's pre and register routes
    ("dense_gn_silu_int8.cu", "dense_gn_silu_int8_wgmma8_kernel"),  # K13 from the int8 copy
    ("head_em.cu", "head_em_body"),  # K2 and its imputation instantiation
    ("head_adam.cu", "head_adam_body"),  # K6 and its perturbing instantiation
    ("pose_elementwise.cu", "comp_perturb_kernel"),  # K5
]

# (file, function): the host functions that launch them, each with the
# programmatic attribute
LAUNCHING = [
    ("dense_gn_silu.cu", "launch_bf16"),
    ("dense_gn_silu.cu", "launch_pre"),
    ("dense_gn_silu_int8.cu", "launch_gs"),
    ("dense_gn_silu_int8.cu", "launch_pre"),
    ("head_em.cu", "dposer_head_em"),
    ("head_em.cu", "dposer_head_em_impute"),
    ("head_adam.cu", "dposer_head_adam"),
    ("head_adam.cu", "dposer_head_adam_perturb"),
    ("pose_elementwise.cu", "dposer_comp_perturb"),
]

# the kernels of those files that stay plain stream launches, with why
SERIAL = {
    "dense_int8_product_wgmma8_kernel",  # K13's main loop alone: the exact check of the loop
    "masked_renoise_kernel",  # K4, outside the sampling chains' list
}

# the train step's kernels: eager launches, torch ops between them
TRAIN_STEP = ["dense_gn_silu_train.cu", "dense_gn_silu_bwd.cu", "head_dsm.cu"]

WAITS = ("grid_dependency_wait()", "Programmatic")
# the cluster heads wait twice: warp 0 in start_copies (its Programmatic
# tag), the epilogue warps on their own
BOTH = {"head_em_body", "head_adam_body"}


def _strip_comments(text):
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _source(name):
    return _strip_comments((CSRC / name).read_text())


def _kernels(text):
    """The names of the ``__global__`` functions defined in ``text``."""
    names = []
    for m in re.finditer(r"__global__", text):
        for call in re.finditer(r"\b(\w+)\s*\(", text[m.end():]):
            if not call.group(1).startswith("__"):  # __launch_bounds__, __cluster_dims__
                names.append(call.group(1))
                break
    return names


def _definitions(text, name):
    """The bodies of every definition of the function ``name`` in ``text``
    (its parameter list followed by a braced body)."""
    bodies = []
    for m in re.finditer(rf"\b{re.escape(name)}\s*\(", text):
        i, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        rest = text[i:].lstrip()
        while rest.startswith("const"):
            rest = rest[len("const"):].lstrip()
        if not rest.startswith("{"):
            continue
        j = len(text) - len(rest) + 1
        depth = 1
        while depth:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            j += 1
        bodies.append(text[m.start():j])
    return bodies


@pytest.mark.parametrize("source,kernel", WAITING)
def test_every_chained_kernel_waits(source, kernel):
    bodies = _definitions(_source(source), kernel)
    assert bodies, f"{kernel} not found in {source}"
    for body in bodies:
        waits = all if kernel in BOTH else any
        assert waits(w in body for w in WAITS), f"{source}: {kernel} does not wait"


@pytest.mark.parametrize("source,function", LAUNCHING)
def test_every_chained_launch_is_programmatic(source, function):
    bodies = _definitions(_source(source), function)
    assert bodies, f"{function} not found in {source}"
    for body in bodies:
        assert "<<<" not in body, f"{source}: {function} launches with <<<>>>"
        assert "launch_programmatic(" in body or "Programmatic>" in body, (
            f"{source}: {function} launches without the programmatic attribute")


@pytest.mark.parametrize("source", sorted({s for s, _ in WAITING}))
def test_no_kernel_of_the_chains_files_launches_without_its_wait(source):
    """A ``__global__`` kernel added to these files later must wait (or be
    named in ``SERIAL``); nothing there launches with ``<<<>>>`` but the
    serial kernels."""
    text = _source(source)
    waiting = [f for s, f in WAITING if s == source]
    kernels = _kernels(text)
    assert kernels
    for name in kernels:
        if name in SERIAL or name in waiting:
            continue
        bodies = _definitions(text, name)  # a kernel whose body is a waiting function
        assert bodies and all(any(re.search(rf"\b{f}\s*<", b) for f in waiting)
                              for b in bodies), f"{source}: {name} never waits"
    for launch in re.findall(r"(\w+)(?:<[^<>]*>)?<<<", text):
        assert launch in SERIAL, f"{source}: {launch} launched with <<<>>>"


def test_the_launch_helpers_set_the_attribute():
    """The attribute is written once, in ``cluster_config``, and the main
    loops' launch helpers pass a programmatic tag through to it."""
    mbar = _source("mbarrier.cuh")
    (config,) = _definitions(mbar, "cluster_config")
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in config
    assert "programmaticStreamSerializationAllowed = 1" in config
    assert mbar.count("cudaLaunchAttributeProgrammaticStreamSerialization") == 1
    (wait,) = _definitions(mbar, "grid_dependency_wait")
    assert "griddepcontrol.wait" in wait
    for header in ("dense_wgmma.cuh", "dense_wgmma_int8.cuh"):
        (launch,) = _definitions(_source(header), "launch")
        assert "Dep::kProgrammatic" in launch and "launch_programmatic(" in launch, header


@pytest.mark.parametrize("source", TRAIN_STEP)
def test_train_step_kernels_keep_their_plain_launch(source):
    text = _source(source)
    assert not any(w in text for w in WAITS + ("launch_programmatic",)), source


def test_programmatic_launches_are_counted_per_kernel():
    """``programmatic_counts`` names the chains' kernels, and
    ``reset_launch_counts`` sets them to 0."""
    fused_em.head_em.programmatic += 2
    fused_em.reset_launch_counts()
    assert fused_em.programmatic_counts() == {
        k: 0 for k in ("dense_gn_silu", "head_em", "head_em_impute", "comp_perturb", "head_adam",
                       "head_adam_perturb", "dense_gn_silu_int8")}
