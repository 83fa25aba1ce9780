"""Training at scale in the port against the JAX package: the sharded
train step (FSDP + data + tensor parallel, int8 across pods), meshes,
training's sharding specs, ``make_global_batch``, gradient
compression, the GPipe pipeline, the elastic restore of a sharded
checkpoint and ``launch.train``'s restart.

Rank groups of 2 and 4 processes are spawned under gloo on the CPU
(``launch.train.train_ranks``: ``file://`` rendezvous under the test's
temporary directory, one torch thread each) once per module and shared
by the tests.  Each runs ``launch.train.train`` on reduced gpt2-xl and
reduced granite-moe-1b-a400m (dropless) for 3 steps of (4, 16)
``SyntheticLM`` batches: at (data 2, model 1), (1, 2), (2, 2) the
metrics and the final params must equal the one-device port run's and
the JAX one-device step's (each package's own init, bridged) at
``test_torch_train.py``'s tolerance, and every leaf must be bit for bit
equal on the ranks that hold the same slice of it; at (pod 2, data 1,
model 1) with ``grad_compress`` every step's loss and gradient norm
must be the int8 step's -- the JAX step's and the one-device port's
with ``grad_compress`` on a (1, 1, 1) ("pod", "data", "model") mesh,
which quantize the whole gradient as the reference's step does at any
pod count -- within int8 noise, and the uncompressed run's too.

Tolerances: RTOL 1e-4 relative to each leaf's largest magnitude
(float32 summed in another order across ranks), bitwise across ranks
and on the checkpoints, 1e-5 on the pipeline (as the reference's test),
the reference's bounds on compression of identical replicas (error <
1e-2, error-feedback reconstruction < 1e-5).  INT8_RTOL = 1/127, one
step of the int8 grid relative to a leaf's largest magnitude: the pods
quantize their shares on a common grid where the one-device step
quantizes their sum, so each gradient element differs by a step or two
of the grid, and a loss or gradient norm by well under one step
relative; a biased hop (each pod on its own scale, dequantized with the
largest) is off by 9-39%.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import SyntheticConfig as JSynthConfig  # noqa: E402
from repro.data import SyntheticLM as JSynthLM  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro.launch.mesh import make_mesh as jax_make_mesh  # noqa: E402
from repro.models import init_decode_state as jax_decode_state  # noqa: E402
from repro.parallel import compress as jcompress  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_global_batch  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.launch.mesh import (AXES, Mesh, make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import compress  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

CPU = "cpu"
RTOL = 1e-4
INT8_RTOL = 1.0 / 127
RANK_TIMEOUT = 240.0
MODELS = ("gpt2-xl", "granite-moe-1b-a400m")
KW = dict(steps=3, batch=4, seq=16, lr=1e-3, seed=0, ckpt_dir=None)
MESHES = {"dp": ((2, 1), ("data", "model")),
          "tp": ((1, 2), ("data", "model")),
          "pod": ((2, 1, 1), ("pod", "data", "model")),
          "pod 1": ((1, 1, 1), ("pod", "data", "model")),
          "fsdp+tp": ((2, 2), ("data", "model"))}


def _cfgs(name):
    cfg, jcfg = get_config(name).reduced(), jax_config(name).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.0))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=0.0))
    return cfg, jcfg


def _stand_in(shape, axes):
    """What ``ShardingRules.spec`` reads of a mesh: its shape."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _rel_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (err, rtol * scale)


def _leaves(tree):
    return {p: x for p, x in tree_leaves_with_path(tree) if x is not None}


# ---------------------------------------------------------------------------
# jobs and module-scoped rank groups
# ---------------------------------------------------------------------------

class _CompressJob:
    """``compress_cross_pod`` and its error-feedback variant of identical
    replicas on the ("pod", "data") mesh of ``shape``, and
    ``compress_cross_pod`` of unequal ones (pod ``i``'s a seeded normal
    tensor times 10^i, whose max-abs values differ 10-fold)."""
    label = "compress"

    def __init__(self, shape):
        self.shape = shape

    def execute(self, device):
        mesh = make_mesh(self.shape, ("pod", "data"), device=device)
        g = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
        avg = compress.compress_cross_pod(g, mesh)
        avg2, r2 = compress.compress_cross_pod_ef(
            g, compress.init_residual(g), mesh)
        pods = [{"w": torch.randn((64, 64), generator=torch.Generator()
                                  .manual_seed(i)) * 10.0 ** i}
                for i in range(self.shape[0])]
        mixed = compress.compress_cross_pod(pods[mesh.coords["pod"]], mesh)
        out = {k: v["w"].numpy() for k, v in
               (("g", g), ("avg", avg), ("avg2", avg2), ("r2", r2),
                ("mixed", mixed))}
        out["mean"] = (sum(x["w"] for x in pods) / len(pods)).numpy()
        out["grid"] = max(float(x["w"].abs().max()) for x in pods) / 127
        return out


def _pipe_job(p):
    """``pipeline_apply`` over ``p`` reduced gpt2-xl layers (8
    microbatches of one (16, 128) sequence each)."""
    cfg = get_config("gpt2-xl").reduced(n_layers=p)
    params = T.init_lm_params(cfg, 3, device=CPU)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((8, 16, cfg.d_model), generator=g)
    return LT.PipeRun(f"pipe {p}", (p,), ("pipe",), params["blocks"][0], x,
                      functools.partial(LT.block_stage, cfg),
                      n_microbatches=8)


def _train_jobs(labels, ckpt_dir=None):
    jobs = []
    for label in labels:
        shape, axes = MESHES[label]
        for name in MODELS:
            kw = dict(KW, grad_compress=(label == "pod"))
            if ckpt_dir is not None and name == "gpt2-xl":
                kw.update(ckpt_dir=str(ckpt_dir), ckpt_every=100)
            jobs.append(LT.TrainRun(f"{name} {label}", _cfgs(name)[0],
                                    shape, axes, kw, local=True, full=True))
    return jobs


def _by_label(jobs, per_rank):
    return {job.label: [r[i] for r in per_rank] for i, job in enumerate(jobs)}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jobs = (_train_jobs(("dp", "tp", "pod")) + [_pipe_job(2)]
            + [_CompressJob((2, 1))])
    out = LT.train_ranks(jobs, 2, backend="gloo", device=CPU, threads=1,
                         timeout=RANK_TIMEOUT,
                         workdir=str(tmp_path_factory.mktemp("pair")))
    return _by_label(jobs, out)


# the launcher's CLOVER options on the (2, 2) mesh: CLOVER-S training of
# the decomposed model's transitions, and training after pruning
OPTIONS = {"peft": dict(peft="clover"), "prune": dict(prune_ratio=0.5),
           "peft+prune": dict(peft="clover", prune_ratio=0.5)}


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    shape, axes = MESHES["fsdp+tp"]
    jobs = (_train_jobs(("fsdp+tp",), ckpt_dir=ckpt) + [_pipe_job(4)]
            + [LT.TrainRun(label, _cfgs("gpt2-xl")[0], shape, axes,
                           dict(KW, **kw), local=True, full=True)
               for label, kw in OPTIONS.items()])
    out = LT.train_ranks(jobs, 4, backend="gloo", device=CPU, threads=1,
                         timeout=RANK_TIMEOUT,
                         workdir=str(tmp_path_factory.mktemp("quad")))
    return _by_label(jobs, out), ckpt


def _jax_run(jcfg, init, mesh, **tcfg_kw):
    """The JAX step for ``KW``'s steps on the port's initial weights and
    ``SyntheticLM``'s batches: -> (per-step metrics, final leaves)."""
    jp = jax.tree.map(jnp.asarray, to_numpy(init))
    tcfg = JS.TrainConfig(optimizer=JO.AdamWConfig(lr=KW["lr"]),
                          warmup_steps=2, total_steps=KW["steps"],
                          remat=True, **tcfg_kw)
    jstep = jax.jit(JS.make_train_step(jcfg, tcfg, mesh)[0])
    jo = JS.make_opt_state(jp)
    data = JSynthLM(JSynthConfig(vocab_size=jcfg.vocab_size,
                                 seq_len=KW["seq"],
                                 global_batch=KW["batch"], seed=0))
    jmet = []
    for i in range(KW["steps"]):
        b = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
        jp, jo, m = jstep(jp, jo, b)
        jmet.append({k: float(v) for k, v in m.items()})
    return jmet, {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                  jax.tree_util.tree_flatten_with_path(jp)[0]}


@pytest.fixture(scope="module")
def one_device():
    """Per model: the one-device port run (``launch.train.train``) and
    the JAX step on the port's initial weights and the same batches;
    and both with ``grad_compress`` on a (1, 1, 1) pod mesh (``int8``,
    ``jax_int8_metrics``)."""
    out = {}
    shape, axes = MESHES["pod 1"]
    for name in MODELS:
        cfg, jcfg = _cfgs(name)
        port = LT.train(cfg, device=CPU, log=None, **KW)
        int8 = LT.train(cfg, log=None, grad_compress=True,
                        mesh=make_mesh(shape, axes, device=CPU), **KW)
        init = T.init_lm_params(cfg, KW["seed"], device=CPU)
        jmet, jfinal = _jax_run(jcfg, init, jax_host_mesh())
        jmet8, jfinal8 = _jax_run(jcfg, init, jax_make_mesh(shape, axes),
                                  grad_compress=True)
        out[name] = dict(port=port, init=init, jax_metrics=jmet,
                         jax_params=jfinal, int8=int8,
                         jax_int8_metrics=jmet8, jax_int8_params=jfinal8)
    return out


@pytest.mark.parametrize("name", MODELS)
def test_one_device_launcher_run_matches_jax(one_device, name):
    """The yardstick itself: ``launch.train.train`` on one device against
    the JAX step, step for step and leaf for leaf."""
    ref = one_device[name]
    for got, want in zip(ref["port"].report.metrics_history,
                         ref["jax_metrics"]):
        for k in ("loss", "grad_norm", "lr_scale"):
            _rel_close(got[k], want[k])
    for p, t in _leaves(ref["port"].params).items():
        _rel_close(t.numpy(), ref["jax_params"][p])
    assert ref["port"].report.steps_run == KW["steps"]


def _check_against(runs, port, jax_ref=None):
    """Every rank's metrics, and the gathered final params, against the
    one-device port run (and the JAX step's, when given)."""
    for r in runs:
        for i, want in enumerate(port.report.metrics_history):
            for k in ("loss", "grad_norm", "lr_scale"):
                _rel_close(r["metrics"][i][k], want[k])
                if jax_ref is not None:
                    _rel_close(r["metrics"][i][k],
                               jax_ref["jax_metrics"][i][k])
    full = runs[0]["full"]
    for p, want in _leaves(port.params).items():
        _rel_close(full[p], want.numpy())
        if jax_ref is not None:
            _rel_close(full[p], jax_ref["jax_params"][p])


def _check_replicas(runs, params, shape, axes):
    """Every leaf bit for bit on the ranks that hold the same slice of it
    (``params``: the whole tree, for its specs)."""
    specs = sh.specs_by_path(params, sh.param_specs(
        params, _stand_in(shape, axes)))
    for p, spec in specs.items():
        groups = {}
        for r in runs:
            key = tuple(r["coords"][a] for a in sorted(sh.split_axes(spec)))
            groups.setdefault(key, []).append(r["local"][p])
        for same in groups.values():
            for leaf in same[1:]:
                assert leaf.tobytes() == same[0].tobytes(), p


def _check_run(runs, ref, shape, axes):
    """One run's ranks against the one-device port and JAX runs, and its
    leaves bit for bit across the ranks holding the same slice."""
    _check_against(runs, ref["port"], ref)
    _check_replicas(runs, ref["init"], shape, axes)


@pytest.mark.parametrize("label", ["dp", "tp"])
@pytest.mark.parametrize("name", MODELS)
def test_sharded_step_matches_one_device_and_jax(pair, one_device, label,
                                                 name):
    shape, axes = MESHES[label]
    runs = pair[f"{name} {label}"]
    assert [r["coords"] for r in runs] == [
        dict(zip(axes, np.unravel_index(k, shape))) for k in range(2)]
    _check_run(runs, one_device[name], shape, axes)
    coll = runs[0]["collectives"]
    if label == "dp":         # FSDP: gathers forward, reduce-scatters back
        assert coll["all_gather"] > 0 and coll["reduce_scatter"] > 0
    else:                     # tensor parallel: all-reduces only
        assert coll["all_gather"] == coll["reduce_scatter"] == 0
        assert coll["all_reduce"] > 0


@pytest.mark.parametrize("name", MODELS)
def test_fsdp_and_tensor_parallel_on_four_ranks(quad, one_device, name):
    runs = quad[0][f"{name} fsdp+tp"]
    assert [r["coords"] for r in runs] == [
        {"data": k // 2, "model": k % 2} for k in range(4)]
    _check_run(runs, one_device[name], *MESHES["fsdp+tp"])


@pytest.mark.parametrize("option", list(OPTIONS))
def test_clover_options_on_four_ranks(quad, option):
    """``train(peft="clover")`` (only the CLOVER-S transitions train,
    FSDP-split frozen leaves gathered without a graph) and
    ``prune_ratio`` on (2, 2) against the same one-device run."""
    cfg = _cfgs("gpt2-xl")[0]
    port = LT.train(cfg, device=CPU, log=None, **dict(KW, **OPTIONS[option]))
    runs = quad[0][option]
    _check_against(runs, port)
    _check_replicas(runs, port.params, *MESHES["fsdp+tp"])


@pytest.mark.parametrize("name", MODELS)
def test_one_device_int8_step_matches_jax(one_device, name):
    """The pod run's yardstick: ``grad_compress`` on a (1, 1, 1) pod mesh
    quantizes the whole gradient, as the JAX step does there (and, on
    its replicated gradients, at any pod count): metrics at RTOL, the
    final params within one int8 step (a rounding flipped by float32
    noise moves an element's update)."""
    ref = one_device[name]
    for got, want in zip(ref["int8"].report.metrics_history,
                         ref["jax_int8_metrics"]):
        for k in ("loss", "grad_norm", "lr_scale"):
            _rel_close(got[k], want[k])
    for p, t in _leaves(ref["int8"].params).items():
        _rel_close(t.numpy(), ref["jax_int8_params"][p], INT8_RTOL)
    # the hop ran: int8 rounding moved the first gradient norm
    assert (ref["int8"].report.metrics_history[0]["grad_norm"]
            != ref["port"].report.metrics_history[0]["grad_norm"])


@pytest.mark.parametrize("name", MODELS)
def test_pod_run_within_int8_noise(pair, one_device, name):
    """(pod 2, data 1, model 1) with ``grad_compress``: every step's loss
    and gradient norm on every rank within INT8_RTOL of the int8 step's
    (JAX's and the port's on one device) and of the uncompressed run's;
    both pods hold the same bytes."""
    runs = pair[f"{name} pod"]
    ref = one_device[name]
    wants = (ref["jax_int8_metrics"], ref["int8"].report.metrics_history,
             ref["port"].report.metrics_history)
    for r in runs:
        assert len(r["metrics"]) == KW["steps"]
        for i, got in enumerate(r["metrics"]):
            for want in wants:
                for k in ("loss", "grad_norm"):
                    _rel_close(got[k], want[i][k], INT8_RTOL)
        assert r["collectives"]["all_reduce"] > 0
    # both pods hold the same bytes: the int8 hop's sum on a common scale
    for p in runs[0]["local"]:
        assert runs[0]["local"][p].tobytes() == runs[1]["local"][p].tobytes()


# ---------------------------------------------------------------------------
# the elastic restore, the pipeline, compression
# ---------------------------------------------------------------------------

def _rank(shape, axes, coords):
    return Mesh(dict(zip(axes, shape)), dict(zip(axes, coords)), None, (),
                torch.device(CPU))


def test_elastic_restore_from_four_ranks(quad):
    """The (2, 2) run's checkpoint (rank 0 gathered and wrote it)
    restores onto (1, 2) and one device: diff 0.0 against the gathered
    params."""
    results, ckpt = quad
    full = results["gpt2-xl fsdp+tp"][0]["full"]
    cm = CheckpointManager(str(ckpt))
    assert cm.all_steps() == [KW["steps"]]
    cfg = _cfgs("gpt2-xl")[0]
    like = {"params": T.init_lm_params(cfg, 1, device=CPU)}
    whole, extra = cm.restore(KW["steps"], like)
    assert extra["step"] == KW["steps"]
    assert extra["data"] == {"step": KW["steps"], "seed": 0}
    for p, t in _leaves(whole["params"]).items():
        assert np.abs(t.numpy() - full[p]).max() == 0.0, p
    specs = sh.param_specs(like["params"], _stand_in((1, 2),
                                                     ("data", "model")))
    for m in range(2):
        mesh = _rank((1, 2), ("data", "model"), (0, m))
        want = sh.shard_tree(whole["params"], specs, mesh)
        got, _ = cm.restore(KW["steps"], {"params": want},
                            {"params": specs}, mesh)
        for p, t in _leaves(got["params"]).items():
            assert np.abs(t.numpy() - _leaves(want)[p].numpy()).max() == 0.0


@pytest.mark.parametrize("p", [2, 4])
def test_pipeline_matches_sequential(pair, quad, p):
    runs = (pair if p == 2 else quad[0])[f"pipe {p}"]
    ref = runs[0]["sequential"]
    for r in runs:
        assert float(np.abs(r["out"] - ref).max()) < 1e-5
        assert r["out"].tobytes() == runs[0]["out"].tobytes()
    sends = sum(r["collectives"]["send"] for r in runs)
    assert sends == 8 * (p - 1)              # each microbatch, each hop


def test_compress_identical_replicas_at_pod_two(pair):
    for r in pair["compress"]:
        g = r["g"]
        assert np.abs(r["avg"] - g).max() < 1e-2     # int8 noise
        assert np.abs(r["avg2"] + r["r2"] - g).max() < 1e-5   # EF exact
        assert r["avg"].tobytes() == pair["compress"][0]["avg"].tobytes()


def test_compress_unequal_pods_on_a_common_scale(pair):
    """Unequal pods: the int8 average is the pods' mean within half a
    step of their common grid (the largest max-abs / 127; a pod
    dequantized on another pod's scale is off by many steps), the same
    bytes on both pods."""
    for r in pair["compress"]:
        err = r["mixed"].astype(np.float64) - r["mean"]
        assert np.abs(err).max() <= 0.5 * r["grid"] * (1 + 1e-5)
        assert r["mixed"].tobytes() == pair["compress"][0]["mixed"].tobytes()


def test_compress_at_pod_one_matches_jax():
    mesh = make_mesh((1, 1), ("pod", "data"), device=CPU)
    jmesh = jax_make_mesh((1, 1), ("pod", "data"))
    rng = np.random.default_rng(5)
    g = {"a": rng.normal(size=(6, 5)).astype(np.float32),
         "b": (rng.normal(size=(7,)) * 1e-3).astype(np.float32)}
    r = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
         for k, v in g.items()}
    tg, tr = from_numpy(g, CPU), from_numpy(r, CPU)
    jg, jr = jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r)
    got = compress.compress_cross_pod(tg, mesh)
    want = jcompress.compress_cross_pod(jg, jmesh)
    got2, gres = compress.compress_cross_pod_ef(tg, tr, mesh)
    want2, wres = jcompress.compress_cross_pod_ef(jg, jr, jmesh)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got2[k].numpy(), np.asarray(want2[k]))
        np.testing.assert_array_equal(gres[k].numpy(), np.asarray(wres[k]))
    zero = compress.init_residual(tg)
    assert all(torch.equal(zero[k], torch.zeros_like(tg[k])) for k in g)


# ---------------------------------------------------------------------------
# meshes, specs, batches
# ---------------------------------------------------------------------------

def test_single_process_meshes():
    mesh = make_mesh((1, 1, 1, 1), AXES, device=CPU)
    assert mesh.shape == dict.fromkeys(AXES, 1) and mesh.size == 1
    assert mesh.coords == dict.fromkeys(AXES, 0) and mesh.rank == 0
    assert mesh.groups == dict.fromkeys(AXES) and mesh.model_ranks == (0,)
    with pytest.raises(ValueError, match="initialised"):
        make_mesh((2, 1), ("data", "model"), device=CPU)
    with pytest.raises(ValueError, match="unknown"):
        make_mesh((1,), ("expert",), device=CPU)
    with pytest.raises(ValueError, match="initialised"):
        make_production_mesh(device=CPU)


MESH_CASES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
              ((2, 2), ("data", "model")), ((2, 4, 2), ("pod", "data",
                                                        "model")),
              ((3, 2), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", MESH_CASES)
def test_data_specs_match_the_reference(shape, axes):
    mesh = _stand_in(shape, axes)
    for batch in (None, 1, 4, 6, 16):
        want = jsh.data_specs(mesh, global_batch=batch)
        got = sh.data_specs(mesh, global_batch=batch)
        assert _canon(got) == _canon(want), (batch, got, want)


def test_global_batch_rows_follow_data_specs():
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    batch = {"tokens": np.arange(8 * 3, dtype=np.int32).reshape(8, 3),
             "labels": np.arange(8 * 3, dtype=np.int32).reshape(8, 3) + 1}
    spec = sh.data_specs(_stand_in(shape, axes), global_batch=8)
    assert tuple(spec) == (("pod", "data"), None)
    seen = []
    for k in range(8):
        coords = np.unravel_index(k, shape)
        got = make_global_batch(batch, _rank(shape, axes, coords), spec)
        lo = 2 * (2 * coords[0] + coords[1])
        for key in batch:
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          batch[key][lo:lo + 2])
        seen.append(lo)
    assert sorted(set(seen)) == [0, 2, 4, 6]
    # a batch that does not divide is replicated, and refused for training
    whole = make_global_batch(batch, _rank(shape, axes, (1, 1, 0)),
                              sh.data_specs(_stand_in((3, 1), ("data",
                                                               "model")),
                                            global_batch=8))
    np.testing.assert_array_equal(whole["tokens"].numpy(), batch["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        S.batch_spec(_stand_in((3, 1), ("data", "model")), 8)


def _canon(spec):
    """A spec as a tuple, one-axis tuples as the axis (the reference's
    ``PartitionSpec`` spells ("data",) as "data")."""
    return tuple(m[0] if isinstance(m, tuple) and len(m) == 1 else m
                 for m in spec)


def _spec_leaves(tree, path=""):
    if isinstance(tree, (sh.Spec, PartitionSpec)):
        return {path: _canon(tree)}
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        out.update(_spec_leaves(
            v, f"{path}[{k!r}]" if isinstance(tree, dict)
            else f"{path}[{k}]"))
    return out


@pytest.mark.parametrize("name", ["gpt2-xl", "jamba-v0.1-52b",
                                  "rwkv6-1.6b"])
@pytest.mark.parametrize("shape,axes", MESH_CASES[2:4])
def test_decode_state_and_opt_specs_match_the_reference(name, shape, axes):
    mesh = _stand_in(shape, axes)
    cfg = get_config(name).reduced()
    state = T.init_decode_state(cfg, 4, 32, device=CPU)
    jstate = jax_decode_state(jax_config(name).reduced(), 4, 32)
    got = _spec_leaves(sh.decode_state_specs(state, mesh))
    want = _spec_leaves(jsh.decode_state_specs(jstate, mesh))
    assert got == want
    params = T.init_lm_params(cfg, 0, device=CPU)
    pspec = sh.param_specs(params, mesh)
    assert sh.opt_specs(pspec) is pspec
    tspec = S.train_specs(params, mesh)
    assert tspec["params"] == pspec and tspec["opt"]["m"] == pspec
    assert tspec["opt"]["v"] == pspec and tspec["opt"]["step"] == ()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_restart_equals_clean_run(tmp_path, capsys):
    common = ["--arch", "gpt2-xl", "--reduced", "--steps", "6", "--batch",
              "2", "--seq", "16", "--ckpt-every", "2", "--device", CPU]
    assert LT.main(common + ["--ckpt-dir", str(tmp_path / "clean")]) == 0
    assert "(0 restarts" in capsys.readouterr().out
    assert LT.main(common + ["--ckpt-dir", str(tmp_path / "failed"),
                             "--fail-at", "3"]) == 0
    assert "(1 restarts" in capsys.readouterr().out
    a = tmp_path / "clean" / "step_000000006"
    b = tmp_path / "failed" / "step_000000006"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) > 10
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
