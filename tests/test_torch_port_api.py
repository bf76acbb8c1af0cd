"""The port's public surface: input validation as in the JAX package, the
config and its carry-over from a JAX ``KernelConfig``, the import boundary,
and ``chip_smoke.py``'s refusal to run without a card.
"""

import ast
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.utils.config import KernelConfig as JaxKernelConfig
from tf_seq2seq_losses_tpu_torch import api
from tf_seq2seq_losses_tpu_torch.ops import core, cuda_lattice
from tf_seq2seq_losses_tpu_torch.utils.config import (
    KernelConfig,
    config_from_reference,
    config_override,
    get_config,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tf_seq2seq_losses_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tf_seq2seq_losses_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_prefix_matches_exactly():
    assert _forbidden("tf_seq2seq_losses_tpu.ops.core")
    assert _forbidden("jax.numpy")
    assert not _forbidden("tf_seq2seq_losses_tpu_torch.ops.core")
    assert not _forbidden("jaxtyping_like")


def _args():
    return (torch.tensor([[1, 2]]), torch.zeros(1, 3, 4), torch.tensor([2]),
            torch.tensor([3]))


@pytest.mark.parametrize(
    "change,exc,text",
    [
        (dict(logits=torch.zeros(3, 4)), ValueError, "rank 3"),
        (dict(labels=torch.tensor([1, 2])), ValueError, "labels must be rank 2"),
        (dict(label_length=torch.tensor([2, 2])), ValueError,
         "inconsistent batch dimensions"),
        (dict(labels=torch.tensor([[1.0, 2.0]])), TypeError,
         "labels must be integer typed"),
        (dict(logit_length=torch.tensor([[3]])), ValueError,
         "label_length and logit_length must be rank 1"),
    ],
)
def test_validation_errors_match_jax(change, exc, text):
    labels, logits, ll, gl = _args()
    kw = dict(labels=labels, logits=logits, label_length=ll, logit_length=gl)
    kw.update(change)
    with pytest.raises(exc, match=text):
        api.classic_ctc_loss(**kw)
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    with pytest.raises(exc, match=text):
        jctc.classic_ctc_loss(**jkw)


def test_topology_names():
    labels, logits, ll, gl = _args()
    with pytest.raises(ValueError, match="unknown topology 'x'"):
        api.ctc_loss(labels, logits, ll, gl, 0, topology="x")
    logits = torch.randn(1, 3, 4, generator=torch.Generator().manual_seed(1))
    simplified = api.ctc_loss(labels, logits, ll, gl, 0, topology="simplified")
    assert torch.equal(simplified, api.simplified_ctc_loss(labels, logits, ll, gl, 0))
    assert not torch.equal(simplified, api.classic_ctc_loss(labels, logits, ll, gl, 0))


def test_blank_index_int_or_tensor():
    labels, logits, ll, gl = _args()
    logits = torch.randn(1, 3, 4, generator=torch.Generator().manual_seed(0))
    a = api.classic_ctc_loss(labels, logits, ll, gl, 3)
    b = api.classic_ctc_loss(labels, logits, ll, gl, torch.tensor(3))
    assert torch.equal(a, b)


def test_numpy_inputs_are_accepted():
    labels, logits, ll, gl = _args()
    a = api.classic_ctc_loss(labels.numpy(), logits, ll.numpy(), gl.numpy(), 0)
    assert torch.equal(a, api.classic_ctc_loss(labels, logits, ll, gl, 0))


@pytest.mark.parametrize(
    "call",
    [
        lambda lab, x, ll, gl: api.classic_ctc_loss(lab, x, ll, gl, 0),
        lambda lab, x, ll, gl: api.ctc_loss_from_logproba(lab, x, ll, gl, 0),
        lambda lab, x, ll, gl: api.ctc_loss_gradient(lab, x, ll, gl, 0, "simplified"),
        lambda lab, x, ll, gl: api.SimplifiedCtcLossData(lab, x, ll, gl, 0),
    ],
    ids=["classic_ctc_loss", "ctc_loss_from_logproba", "ctc_loss_gradient",
         "SimplifiedCtcLossData"],
)
def test_numpy_logits_go_to_the_card_or_raise(call, monkeypatch):
    # values that are not a tensor go to the current CUDA device, as the JAX
    # package puts them on its accelerator; never silently on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    labels, logits, ll, gl = _args()
    with pytest.raises(ValueError, match="pass a CPU tensor"):
        call(labels, logits.numpy(), ll, gl)


def test_config_from_reference_maps_the_jax_defaults():
    jax_fields = dataclasses.asdict(JaxKernelConfig())
    cfg = config_from_reference(jax_fields)
    assert cfg == KernelConfig()
    assert (cfg.window, cfg.chunk_time, cfg.repair_bucket2) == (8, 512, 32)
    assert cfg.guard and cfg.log_fallback and cfg.use_kernels is None
    changed = dict(jax_fields, window=4, chunk_time=256, guard=False,
                   repair_bucket2=8, log_fallback=False, block_batch=16,
                   interpret=True, guard_mode="pre", fold_pt=False)
    cfg = config_from_reference(changed)
    assert (cfg.window, cfg.chunk_time, cfg.guard, cfg.repair_bucket2,
            cfg.log_fallback) == (4, 256, False, 8, False)


def test_config_from_reference_maps_stream_residuals():
    fields = dict(dataclasses.asdict(JaxKernelConfig()), stream_residuals=False)
    assert config_from_reference(fields).stream_residuals is False
    assert get_config().stream_residuals is True
    labels, logits, ll, gl = _args()
    ctx = core.make_context(labels, torch.log_softmax(logits, 2), ll, gl, 0)
    with config_override(stream_residuals=False) as cfg:
        assert cfg.stream_residuals is False and get_config() is cfg
        loss, pack = cuda_lattice.classic_loss_and_pack(ctx)
    assert isinstance(pack, cuda_lattice.ChunkPack)
    assert get_config().stream_residuals is True
    streamed, pack = cuda_lattice.classic_loss_and_pack(ctx)
    assert isinstance(pack, cuda_lattice.StreamPack)
    assert torch.equal(loss, streamed)
    with pytest.raises(ValueError, match="stream_residuals"):
        KernelConfig(stream_residuals=0)


@pytest.mark.parametrize("field", ["half_stream", "fused_epilogue"])
def test_config_from_reference_maps_half_stream_and_fused_epilogue(field):
    fields = dict(dataclasses.asdict(JaxKernelConfig()), **{field: True})
    assert getattr(config_from_reference(fields), field) is True
    assert getattr(config_from_reference(dataclasses.asdict(JaxKernelConfig())),
                   field) is False
    with config_override(**{field: True}) as cfg:
        assert getattr(cfg, field) is True and get_config() is cfg
    assert getattr(get_config(), field) is False
    with pytest.raises(ValueError, match=field):
        KernelConfig(**{field: 1})


@pytest.mark.parametrize(
    "field,value,roadmap",
    [("guard_struct", "cond", "A7")],
)
def test_unported_knobs_raise(field, value, roadmap):
    # the last knob that raised (ROADMAP ``roadmap``) is ported: none raises
    fields = dict(dataclasses.asdict(JaxKernelConfig()), **{field: value})
    assert getattr(config_from_reference(fields), field) == value, roadmap
    with config_override(**{field: value}) as cfg:
        assert getattr(cfg, field) == value and get_config() is cfg
    assert getattr(get_config(), field) != value


def test_unknown_values_raise_at_construction():
    with pytest.raises(ValueError, match="guard_struct"):
        config_from_reference({"guard_struct": "whlie"})
    with pytest.raises(ValueError, match="unknown KernelConfig fields"):
        config_from_reference({"widnow": 8})
    for bad in (dict(window=0), dict(use_kernels="yes"), dict(guard=1),
                dict(repair_bucket2=True)):
        with pytest.raises(ValueError):
            KernelConfig(**bad)
    with config_override(guard_struct="while", window=4) as cfg:
        assert cfg.window == 4 and get_config() is cfg
    assert get_config().window == 8


def test_auto_selects_the_pure_path_on_cpu():
    assert not KernelConfig().kernels_enabled(torch.device("cpu"))
    assert KernelConfig().kernels_enabled(torch.device("cuda"))
    assert KernelConfig(use_kernels=True).kernels_enabled(torch.device("cpu"))


def test_kernel_wrappers_refuse_other_devices():
    t = torch.empty((1, 8, 32), device="meta")
    v = torch.empty((1, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_lattice.classic_fwd(t[:, :, 0], t, v, v, v, torch.empty(1, device="meta"),
                                 8, "final")


def _smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_jax_inputs_unchanged_by_the_port():
    # the port and the reference agree on the README example through logits
    ref = np.asarray(jctc.classic_ctc_loss(
        jnp.asarray([[1, 2, 2, 1]]), jnp.zeros((1, 5, 3)), jnp.asarray([4]),
        jnp.asarray([5]), 0))
    ours = api.classic_ctc_loss(torch.tensor([[1, 2, 2, 1]]), torch.zeros(1, 5, 3),
                                torch.tensor([4]), torch.tensor([5]), 0)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
