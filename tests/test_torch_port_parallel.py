"""The port's parallel layer against the JAX package's ``parallel``.

Multi-rank runs happen in subprocesses (``tests/_torch_port_worker.py``,
gloo on the CPU, a ``file://`` rendezvous under the test's temporary
directory, 60 s process-group timeout); the pytest process never joins a
process group.  The JAX references run on this suite's 8 virtual CPU
devices.

Tolerances: per-sample and mean losses 1e-5 and each rank's d_logits atol
1e-5 from JAX (float32 lattices, the JAX suite's gradient tolerance).  The
training steps run the encoder, whose bf16 roundings of near-ties can
flip where a float32 sum is ordered differently (the row-parallel down
projection sums two partial products): two steps' losses are held to
1e-5, as the JAX package holds its own 4-process run against one process
(``tests/_mp_worker4.py``).  The updated parameters are held to atol
1e-4: a bf16 rounding of a cotangent that flips between the frameworks
moves a gradient entry by a bf16 ulp (2^-8 relative), and two steps at
lr 0.1 then move a weight by up to 2.44e-5 here (measured: one entry of
1024, the same on one rank and on two).  The ranks sum each product's
float32 weight cotangent before its bf16 rounding, as XLA sums partial
products, so the two-rank weights equal the one-rank ones.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tf_seq2seq_losses_tpu as jctc
from tf_seq2seq_losses_tpu.models import encoder as jenc
from tf_seq2seq_losses_tpu.parallel import sharding as jsharding
from tf_seq2seq_losses_tpu.parallel import train as jtrain
from tf_seq2seq_losses_tpu_torch import parallel
from tf_seq2seq_losses_tpu_torch.entry import dryrun_multichip
from tf_seq2seq_losses_tpu_torch.models import encoder as enc
from tf_seq2seq_losses_tpu_torch.parallel import sharding
from tf_seq2seq_losses_tpu_torch.parallel import train as ttrain

REPO = str(Path(__file__).resolve().parents[1])
WORKER = str(Path(__file__).resolve().parent / "_torch_port_worker.py")
CPU = torch.device("cpu")
RANK_TIMEOUT_S = 120
LR = 0.1
STEPS = 2
PARAM_ATOL = 1e-4


def run_ranks(case, world, spec, tmp):
    """Run ``case`` of the worker on ``world`` gloo ranks; their results."""
    torch.save(spec, tmp / "in.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, f"file://{tmp}/rendezvous", str(world),
         str(rank), str(tmp / "in.pt"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return [torch.load(tmp / f"rank{rank}.pt") for rank in range(world)]


def encoder_spec(key, feat, hidden, vocab, layers, batch):
    """The worker's inputs: a JAX encoder carried across, the batch."""
    params = jenc.init_encoder(key, num_features=feat, hidden=hidden, vocab=vocab,
                               num_layers=layers)
    port = enc.encoder_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), device=CPU)
    return params, {"dims": (feat, hidden, vocab, layers), "state": port.state_dict(),
                    "batch": {k: torch.as_tensor(v) for k, v in batch.items()},
                    "lr": LR, "steps": STEPS}


def jax_train(params, batch, mesh_shape, axis_names, model_axis):
    mesh = jsharding.make_mesh(mesh_shape, axis_names)
    init_state, shard, step = jtrain.make_train_step(
        mesh, model_axis=model_axis, optimizer=optax.sgd(LR))
    state = init_state(params)
    sharded = shard({k: jnp.asarray(v) for k, v in batch.items()})
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, sharded)
        losses.append(float(loss))
    return np.asarray(losses), state.params


def loss_inputs(batch=8, max_t=12, vocab=5, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(batch, max_t, vocab)).astype(np.float32)
    logit_length = rng.randint(max_t // 2, max_t, batch).astype(np.int32)
    label_length = rng.randint(max_t // 4, max_t // 2, batch).astype(np.int32)
    labels = rng.randint(1, vocab, (batch, max_t // 2)).astype(np.int32)
    return labels, logits, label_length, logit_length


def dp_batch():
    """B=8, T=16, F=8, labels [8, 3]; row 5 (rank 1's second row) has one
    logit frame for three labels: infeasible, so rank 0 has 4 finite
    losses and rank 1 has 3."""
    rng = np.random.RandomState(1)
    feature_length = np.full((8,), 16, np.int32)
    feature_length[5] = 2
    return {
        "features": rng.randn(8, 16, 8).astype(np.float32),
        "feature_length": feature_length,
        "labels": rng.randint(1, 6, (8, 3)).astype(np.int32),
        "label_length": np.full((8,), 3, np.int32),
    }


@pytest.fixture(scope="module")
def data_parallel_run(tmp_path_factory):
    params, spec = encoder_spec(jax.random.PRNGKey(3), 8, 16, 6, 2, dp_batch())
    spec["loss_inputs"] = tuple(torch.as_tensor(a) for a in loss_inputs())
    return params, run_ranks("data_parallel", 2, spec, tmp_path_factory.mktemp("dp"))


def test_param_shardings_match_reference_spec():
    params = jenc.init_encoder(jax.random.PRNGKey(0), num_features=8, hidden=16,
                               vocab=6, num_layers=2)
    port = enc.encoder_params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), device=CPU)
    jmesh = jsharding.make_mesh((4, 2), ("data", "model"))
    mesh = parallel.make_mesh((1, 1), ("data", "model"), device=CPU)
    dims = {(None, "model"): 1, ("model",): 0, ("model", None): 0, (): None}
    for model_axis in ("model", None):
        got = parallel.param_shardings(port, mesh, model_axis)
        leaves = jax.tree_util.tree_flatten_with_path(params)[0]
        assert len(got) == len(leaves)
        for path, _ in leaves:
            keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
            spec = jtrain._param_spec("/" + "/".join(keys), jmesh, model_axis)
            assert got[".".join(keys)] == dims[tuple(spec)], keys


def test_init_distributed_is_a_noop_without_configuration(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "CTC_TPU_COORDINATOR",
                 "CTC_TPU_NUM_PROCESSES", "CTC_TPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert parallel.init_distributed(device=CPU) is False
    assert not torch.distributed.is_initialized()
    assert parallel.is_primary()
    mesh = parallel.global_mesh(("data", "model"), (1, 1), device=CPU)
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group("data") is None and mesh.group("model") is None
    with pytest.raises(ValueError):
        parallel.make_mesh((2,), ("data",), device=CPU)


def test_single_rank_train_step_matches_jax():
    """The 1 x 1 mesh with no process group (every collective the
    identity): two SGD steps' losses and parameters against JAX on one
    device, the TP shard of size 1 included."""
    batch = dp_batch()
    params, spec = encoder_spec(jax.random.PRNGKey(3), 8, 16, 6, 2, batch)
    want, want_params = jax_train(params, batch, (1, 1), ("data", "model"), "model")
    mesh = parallel.make_mesh((1, 1), ("data", "model"), device=CPU)
    init_state, shard, step = parallel.make_train_step(
        mesh, optimizer=lambda p: torch.optim.SGD(p, lr=LR))
    model = enc.Encoder(*spec["dims"], device=CPU)
    model.load_state_dict(spec["state"])
    state = init_state(model)
    local = shard(batch)
    got = [float(step(state, local)[1]) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got_params = enc.encoder_params_to_reference(state.params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                                atol=PARAM_ATOL),
        got_params, want_params)


def test_sharded_losses_on_two_ranks_match_jax(data_parallel_run):
    _, ranks = data_parallel_run
    labels, logits, label_length, logit_length = loss_inputs()
    want = np.asarray(jctc.classic_ctc_loss(labels, logits, label_length,
                                            logit_length, 0))
    got = torch.cat([r["rows"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    mesh = jsharding.make_mesh((2,), ("data",))
    jmean = jsharding.sharded_mean_ctc_loss(mesh)(*jsharding.shard_batch(
        mesh, tuple(jnp.asarray(a) for a in (labels, logits, label_length,
                                             logit_length))))
    for r in ranks:
        np.testing.assert_allclose(float(r["mean"]), float(jmean), rtol=1e-5)


def test_sharded_mean_d_logits_are_the_single_device_rows(data_parallel_run):
    """Each rank's d_logits are its rows of the single-device gradient of
    the mean, not ``world_size`` times them."""
    _, ranks = data_parallel_run
    labels, logits, label_length, logit_length = loss_inputs()
    want = np.asarray(jax.grad(lambda x: jnp.mean(jctc.classic_ctc_loss(
        labels, x, label_length, logit_length, 0)))(jnp.asarray(logits)))
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["d_logits"].numpy(), want[4 * rank:4 * rank + 4],
                                   rtol=0, atol=1e-5)


def test_dp_step_with_an_infeasible_row_on_one_rank(data_parallel_run):
    """Rank 1 holds the one infeasible row: the ranks' finite counts differ
    (4 and 3), and the step still means over the global 7."""
    params, ranks = data_parallel_run
    want, want_params = jax_train(params, dp_batch(), (2,), ("data",), None)
    for r in ranks:
        np.testing.assert_allclose(r["losses"].numpy(), want, rtol=0, atol=1e-5)
        got = enc.Encoder(8, 16, 6, 2, device=CPU)
        got.load_state_dict(r["params"])
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                                    atol=PARAM_ATOL),
            enc.encoder_params_to_reference(got), want_params)


@pytest.mark.parametrize("world", [1, 2])
def test_torch_func_over_the_sharded_losses(world, tmp_path):
    """``torch.func.grad`` of the port's ``sharded_mean_ctc_loss`` against
    ``jax.grad`` of the JAX package's on one device (loss rtol 1e-5,
    gradient atol 1e-4, the JAX suite's tolerances), each rank's rows of
    it; ``vmap`` of the sharded losses, of the mean's ``grad`` and of the
    collectives bit for bit their calls group by group."""
    groups = tuple(tuple(torch.as_tensor(a) for a in loss_inputs(seed=seed))
                   for seed in (1, 2, 3))
    spec = {"loss_inputs": tuple(torch.as_tensor(a) for a in loss_inputs()),
            "groups": groups}
    ranks = run_ranks("func", world, spec, tmp_path)
    labels, logits, label_length, logit_length = loss_inputs()
    mesh = jsharding.make_mesh((1,), ("data",))
    jlabels, jlogits, jll, jgl = jsharding.shard_batch(
        mesh, tuple(jnp.asarray(a) for a in (labels, logits, label_length,
                                             logit_length)))
    mean_fn = jsharding.sharded_mean_ctc_loss(mesh)
    want, want_grad = jax.value_and_grad(
        lambda x: mean_fn(jlabels, x, jll, jgl))(jlogits)
    rows = len(labels) // world
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(float(r["mean"]), float(want), rtol=1e-5)
        np.testing.assert_allclose(
            r["d_logits"].numpy(), np.asarray(want_grad)[rank * rows:(rank + 1) * rows],
            rtol=0, atol=1e-4)
        for name in ("rows", "means", "grads", "gathered", "copy_grads"):
            assert torch.equal(r[name], r[name + "_loop"]), name
        assert torch.equal(r["gathered_dim1"], r["gathered_loop"])
        xs = [torch.randn(3, 3, 4, generator=torch.Generator().manual_seed(k))
              for k in range(world)]
        assert torch.equal(r["gathered"], torch.cat(xs, dim=-1))
        assert torch.equal(r["copy_grads"],
                           world * torch.linspace(-1.0, 1.0, 4).expand(3, 3, 4))


def test_the_eager_body_is_the_cpu_step():
    """On a CPU mesh ``train_step`` is ``train_step_eager``, bit for bit."""
    batch = dp_batch()
    _, spec = encoder_spec(jax.random.PRNGKey(3), 8, 16, 6, 2, batch)
    mesh = parallel.make_mesh((1, 1), ("data", "model"), device=CPU)
    results = []
    for eager in (False, True):
        init_state, shard, step = parallel.make_train_step(mesh)
        model = enc.Encoder(*spec["dims"], device=CPU)
        model.load_state_dict(spec["state"])
        state = init_state(model)
        local = shard(batch)
        losses = [(ttrain.train_step_eager(state, local) if eager
                   else step(state, local))[1] for _ in range(STEPS)]
        results.append((torch.stack(losses), state.params.state_dict()))
    assert torch.equal(results[0][0], results[1][0])
    for name, value in results[0][1].items():
        assert torch.equal(value, results[1][1][name]), name


def test_a_graph_needs_a_capturable_optimizer():
    """Adam with ``capturable=False`` cannot be captured: ``ValueError``;
    with ``capturable=True``, or an optimizer without the flag, it can."""
    params = [torch.nn.Parameter(torch.ones(3))]
    with pytest.raises(ValueError, match="capturable"):
        ttrain._check_capturable(torch.optim.Adam(params, capturable=False))
    ttrain._check_capturable(torch.optim.Adam(params, capturable=True))
    ttrain._check_capturable(torch.optim.SGD(params, lr=0.1))


@pytest.mark.parametrize("make_opt", [
    lambda p: torch.optim.Adam(p, lr=LR),
    lambda p: torch.optim.SGD(p, lr=LR, momentum=0.9),
], ids=["adam", "sgd_momentum"])
def test_a_warm_up_step_is_undone(make_opt):
    """``capture_step``'s warm-up is undone (``_snapshot``, ``_restore``):
    after a step and its undoing, two steps give what two steps of a fresh
    state give, bit for bit; so does a state that has stepped before."""
    batch = dp_batch()
    _, spec = encoder_spec(jax.random.PRNGKey(3), 8, 16, 6, 2, batch)
    mesh = parallel.make_mesh((1, 1), ("data", "model"), device=CPU)
    init_state, shard, _ = parallel.make_train_step(mesh, optimizer=make_opt)
    local = shard(batch)

    def fresh():
        model = enc.Encoder(*spec["dims"], device=CPU)
        model.load_state_dict(spec["state"])
        return init_state(model)

    for warm_steps in (0, 1):
        runs = []
        for undo in (False, True):
            state = fresh()
            for _ in range(warm_steps):
                ttrain.train_step_eager(state, local)
            if undo:
                params = [p.detach().clone() for p in state.params.parameters()]
                saved = ttrain._snapshot(state.opt_state)
                ttrain.train_step_eager(state, local)
                ttrain._restore(state.params, state.opt_state, params, saved)
            losses = [ttrain.train_step_eager(state, local)[1] for _ in range(2)]
            runs.append((torch.stack(losses), state.params.state_dict()))
        assert torch.equal(runs[0][0], runs[1][0])
        for name, value in runs[0][1].items():
            assert torch.equal(value, runs[1][1][name]), name


def test_dp_tp_step_on_four_ranks_matches_jax(tmp_path):
    """The 2 x 2 ('data', 'model') step of ``tests/_mp_worker4.py``: B=8,
    T=16, F=8, hidden 16, vocab 8, one layer, SGD(0.1); each data group's
    two ranks hold its rows, each model rank half of up, down and head."""
    rng = np.random.RandomState(0)
    batch = {
        "features": rng.randn(8, 16, 8).astype(np.float32),
        "feature_length": np.full((8,), 16, np.int32),
        "labels": rng.randint(1, 8, (8, 3)).astype(np.int32),
        "label_length": np.full((8,), 3, np.int32),
    }
    params, spec = encoder_spec(jax.random.PRNGKey(7), 8, 16, 8, 1, batch)
    want, _ = jax_train(params, batch, (2, 2), ("data", "model"), "model")
    ranks = run_ranks("dp_tp", 4, spec, tmp_path)
    for r in ranks:
        np.testing.assert_allclose(r["losses"].numpy(), want, rtol=0, atol=1e-5)
    # each model rank holds its half of the sharded parameters
    assert ranks[0]["params"]["blocks.0.up.w"].shape == (16, 32)
    assert ranks[1]["params"]["head.w"].shape == (16, 4)
    assert not torch.equal(ranks[0]["params"]["head.w"], ranks[1]["params"]["head.w"])
    torch.testing.assert_close(ranks[0]["params"]["stem.w"],
                               ranks[1]["params"]["stem.w"], rtol=0, atol=0)


def test_tp_shard_rejects_widths_that_do_not_divide():
    model = enc.Encoder(4, 8, 5, 1, device=CPU)
    # rank 0 of a 1 x 2 mesh, built without a process group: vocab 5 does
    # not divide over the model axis
    mesh = sharding.Mesh((1, 2), ("data", "model"), CPU)
    init_state, _, _ = parallel.make_train_step(mesh)
    with pytest.raises(ValueError, match="vocab"):
        init_state(model)
    assert ttrain.param_shardings(model, mesh, None) == {
        name: None for name, _ in model.named_parameters()}


def test_dryrun_multichip_four_ranks():
    dryrun_multichip(4, timeout=RANK_TIMEOUT_S)



def test_a_replay_holds_what_the_capture_fixed():
    """A captured step fixes the parameters and the optimizer's
    hyperparameters (``train._fixed``): a changed Python ``lr`` or a
    replaced parameter makes the replay raise ``ValueError`` before it
    runs; a tensor ``lr`` updated in place, and the ``initial_lr`` that a
    scheduler adds, do not."""
    model = enc.Encoder(8, 16, 6, 1, device=CPU)
    lr = torch.tensor(LR)
    opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=True)
    state = ttrain.TrainState(model, opt)
    captured = ttrain._Captured(None, {}, torch.zeros(()), ttrain._fixed(state))
    lr.fill_(LR / 2)
    torch.optim.lr_scheduler.StepLR(opt, step_size=1)
    assert ttrain._same(ttrain._fixed(state), captured.fixed)
    opt.param_groups[0]["lr"] = LR / 2
    with pytest.raises(ValueError, match="hyperparameters"):
        ttrain.replay(captured, state, {})
    opt.param_groups[0]["lr"] = lr
    assert ttrain._same(ttrain._fixed(state), captured.fixed)
    model.head.w = torch.nn.Parameter(model.head.w.detach().clone())
    with pytest.raises(ValueError, match="parameters"):
        ttrain.replay(captured, state, {})
