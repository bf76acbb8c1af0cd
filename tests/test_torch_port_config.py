"""The port's config against the JAX package's: every field carried across
or dropped by name, the ``CTC_TPU_*`` variables parsed alike, and the JAX
config's TPU-only knobs accepted by ``config_override``."""

import dataclasses

import pytest

from tf_seq2seq_losses_tpu.utils import config as jax_config_mod
from tf_seq2seq_losses_tpu.utils.config import KernelConfig as JaxKernelConfig
from tf_seq2seq_losses_tpu_torch.utils import config as port_config_mod
from tf_seq2seq_losses_tpu_torch.utils.config import (
    KernelConfig,
    config_from_reference,
    config_override,
    get_config,
)

# a value off the default for every field the port honours
OFF_DEFAULT = dict(window=4, chunk_time=256, stream_residuals=False, half_stream=True,
                   fused_epilogue=True, guard=False, repair_bucket=3, repair_bucket2=7,
                   log_fallback=False, guard_mode="pre", guard_struct="cond",
                   guard_tier1=True)
TPU_ONLY = dict(use_pallas=True, interpret=True, unroll=False, block_batch=2,
                block_time=4, vmem_budget_mb=8, vmem_limit_mb=16, sort_by_length=False,
                fold_pt=False)
# (variable, field, values tried): the variables the port reads
ENV = [
    ("CTC_TPU_GUARD", "guard", ["0", "false", "False", "1", "no"]),
    ("CTC_TPU_STREAM_RESIDUALS", "stream_residuals", ["0", "False", "1"]),
    ("CTC_TPU_LOG_FALLBACK", "log_fallback", ["false", "1"]),
    ("CTC_TPU_FUSED_EPILOGUE", "fused_epilogue", ["1", "0", "yes", "False"]),
    ("CTC_TPU_HALF_STREAM", "half_stream", ["1", "true", "0", "yes"]),
    ("CTC_TPU_GUARD_MODE", "guard_mode", ["pre", "grad", "post", "bogus"]),
    ("CTC_TPU_GUARD_STRUCT", "guard_struct", ["cond", "while", "whlie"]),
    ("CTC_TPU_GUARD_TIER1", "guard_tier1", ["1", "0", "false"]),
    ("CTC_TPU_WINDOW", "window", ["4", "16"]),
    ("CTC_TPU_REPAIR_BUCKET", "repair_bucket", ["0", "2"]),
    ("CTC_TPU_REPAIR_BUCKET2", "repair_bucket2", ["4", "64"]),
    ("CTC_TPU_CHUNK_TIME", "chunk_time", ["128", "1024"]),
]


def test_every_jax_field_is_mapped_or_dropped_by_name():
    jax_fields = {f.name for f in dataclasses.fields(JaxKernelConfig)}
    own = {f.name for f in dataclasses.fields(KernelConfig)} - {"use_kernels"}
    assert jax_fields == own | set(port_config_mod._DROPPED)
    assert set(OFF_DEFAULT) == own and set(TPU_ONLY) == set(port_config_mod._DROPPED)
    fields = dataclasses.asdict(JaxKernelConfig(**OFF_DEFAULT, **TPU_ONLY))
    cfg = config_from_reference(fields)
    assert {k: getattr(cfg, k) for k in OFF_DEFAULT} == OFF_DEFAULT
    assert cfg.use_kernels is None
    assert config_from_reference(dataclasses.asdict(JaxKernelConfig())) == KernelConfig()


@pytest.mark.parametrize("variable,field,values", ENV, ids=[e[0] for e in ENV])
def test_env_default_parses_as_the_jax_package(variable, field, values, monkeypatch):
    for value in values:
        monkeypatch.setenv(variable, value)
        want = getattr(jax_config_mod._env_default(), field)
        assert getattr(port_config_mod._env_default(), field) == want, (variable, value)


def test_tpu_only_variables_are_ignored(monkeypatch):
    for variable in ("CTC_TPU_USE_PALLAS", "CTC_TPU_PALLAS_INTERPRET", "CTC_TPU_UNROLL",
                     "CTC_TPU_FOLD_PT", "CTC_TPU_SORT_BY_LENGTH", "CTC_TPU_BLOCK_BATCH",
                     "CTC_TPU_BLOCK_TIME", "CTC_TPU_VMEM_BUDGET_MB",
                     "CTC_TPU_VMEM_LIMIT_MB"):
        monkeypatch.setenv(variable, "0")
    assert port_config_mod._env_default() == KernelConfig()


def test_config_override_accepts_the_tpu_only_knobs():
    with config_override(**TPU_ONLY, repair_bucket=2, guard_mode="grad") as cfg:
        assert get_config() is cfg
        assert (cfg.repair_bucket, cfg.guard_mode) == (2, "grad")
        assert dataclasses.replace(cfg, repair_bucket=16, guard_mode="post") == KernelConfig()
    assert get_config() == KernelConfig()
    with pytest.raises(TypeError, match="widnow"):
        with config_override(widnow=4):
            pass
    for bad in (dict(guard_mode="late"), dict(guard_struct="for"), dict(repair_bucket=-1),
                dict(guard_tier1=1), dict(repair_bucket2=-1)):
        with pytest.raises(ValueError):
            KernelConfig(**bad)
