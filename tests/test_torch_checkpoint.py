"""The port's checkpoints and supervisor (``train/checkpoint.py``,
``train/supervisor.py``) against the JAX package's.

Port analogues of ``tests/test_train.py``'s checkpoint and supervisor
tests (round trip with bfloat16 and ``None``, keep-k GC, async + atomic
commit, bit-exact resume after a failure, the straggler at step 15);
checkpoints crossing between the packages both ways, bit for bit, with
equal manifests and byte-identical array files; float8 leaves; the
elastic restore onto a smaller mesh's layout; and the supervisor's
replay before the first checkpoint, step for step the reference's.

Tolerances: none -- every comparison is bitwise.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.train.supervisor import Supervisor as JaxSupervisor  # noqa: E402
from repro.train.supervisor import WorkerFailure as JaxFailure  # noqa: E402
from repro_torch.bridge import from_numpy, to_numpy  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.supervisor import (StragglerStats,  # noqa: E402
                                          Supervisor, WorkerFailure)
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

CPU = "cpu"


def _tree():
    """Leaves of several dtypes and ranks, a ``None``, nested tuples and
    a one-element tuple, dict keys out of sorted order."""
    rng = np.random.default_rng(0)
    return {"z": rng.normal(size=(2, 3)).astype(np.float32),
            "nested": {"b": rng.normal(size=(4,)).astype(np.float32),
                       "a": np.int32(3)},
            "blocks": (np.zeros((2, 2), np.float32),
                       {"q": np.full((3,), 7.0, np.float32)}),
            "single": (np.arange(5, dtype=np.int32),),
            "none": None,
            "step": np.zeros((), np.int32)}


def _torch_tree():
    t = from_numpy(_tree(), CPU)
    t["nested"]["b"] = t["nested"]["b"].to(torch.bfloat16)
    return t


def _jax_tree():
    t = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                     _tree(), is_leaf=lambda x: x is None)
    t["nested"]["b"] = t["nested"]["b"].astype(jnp.bfloat16)
    return t


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _assert_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for p in w:
        if w[p] is None:
            assert g[p] is None, p
            continue
        assert g[p].dtype == w[p].dtype and g[p].shape == w[p].shape, p
        assert torch.equal(g[p], w[p]), p


def _assert_same_as_jax(got, jtree):
    """A port tree equal bit for bit to a JAX tree (bfloat16 compared as
    its raw bits)."""
    want = to_numpy(got)
    for p, leaf in jax.tree_util.tree_flatten_with_path(
            jtree, is_leaf=lambda x: x is None)[0]:
        key = jax.tree_util.keystr(p)
        w = _leaves(want)[key]
        if leaf is None:
            assert w is None, key
            continue
        a, b = np.asarray(leaf), np.asarray(w)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


# ---------------------------------------------------------------------------
# the reference's checkpoint and supervisor tests, ported
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = _torch_tree()
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    cm.save(5, tree, {"note": "x"})
    assert cm.latest_step() == 5
    restored, extra = cm.restore(5, tree)
    assert extra["note"] == "x"
    assert restored["nested"]["b"].dtype == torch.bfloat16
    _assert_bitwise(restored, tree)


def test_checkpoint_keep_k_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        cm.save(s, {"x": torch.ones(2) * s})
    assert cm.all_steps() == [3, 4]
    got, _ = cm.restore(4, {"x": torch.zeros(2)})
    assert torch.equal(got["x"], torch.full((2,), 4.0))


def test_checkpoint_async_and_atomic(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    x = torch.arange(10)
    cm.save(1, {"x": x})
    x += 100                    # the snapshot was taken before the thread
    cm.wait()
    assert cm.all_steps() == [1]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    got, _ = cm.restore(1, {"x": x})
    assert torch.equal(got["x"], torch.arange(10))


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("n", [5, 6])
def test_checkpoint_float8_keeps_shape(tmp_path, dtype, n):
    """1-byte floats are saved as a uint8 view, odd lengths included
    (the reference's uint16 view raises on odd and halves even ones)."""
    x = torch.linspace(-3, 3, n).to(dtype)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, {"w": x})
    man = json.loads((tmp_path / "step_000000001" / "manifest.json")
                     .read_text())
    assert man["leaves"][0]["shape"] == [n]
    got, _ = cm.restore(1, {"w": x})
    assert got["w"].dtype == dtype
    assert torch.equal(got["w"].view(torch.uint8), x.view(torch.uint8))


def _supervised(manager, supervisor, failure, root, fail_at, total=12,
                every=4, torch_side=True):
    """The reference test's loop: x += (i + 1) / 2 per step, a failure
    injected once at ``fail_at``."""
    cm = manager(str(root), keep=3, async_write=False)
    sup = supervisor(cm, ckpt_every=every)
    zero = torch.zeros(()) if torch_side else jnp.zeros(())
    failed = {"done": False}

    def step_fn(st, i):
        if i == fail_at and not failed["done"]:
            failed["done"] = True
            raise failure("injected")
        x = st["x"] + (i + 1) * 0.5
        return {"x": x}, {"x": float(x)}

    return sup.run(state={"x": zero}, step_fn=step_fn,
                   save_tree=lambda st: ({"x": st["x"]}, {}),
                   restore_tree=lambda tree, extra: {"x": tree["x"]},
                   start_step=0, total_steps=total)


def test_supervisor_restart_resumes_exactly(tmp_path):
    clean = _supervised(CheckpointManager, Supervisor, WorkerFailure,
                        tmp_path / "clean", fail_at=-1)
    failed = _supervised(CheckpointManager, Supervisor, WorkerFailure,
                         tmp_path / "failed", fail_at=6)
    assert (clean.restarts, failed.restarts) == (0, 1)
    assert clean.metrics_history[-1]["x"] == failed.metrics_history[-1]["x"]
    assert failed.steps_run == 12 + 2         # steps 4 and 5 replayed
    assert failed.final_step == 12


@pytest.mark.parametrize("fail_at", [2, 6, 11])
def test_supervisor_histories_equal_the_references(tmp_path, fail_at):
    """Step for step the reference's loop, a failure before the first
    checkpoint included (both replay from step 0 with the state they
    failed in)."""
    ours = _supervised(CheckpointManager, Supervisor, WorkerFailure,
                       tmp_path / "t", fail_at=fail_at)
    theirs = _supervised(JaxManager, JaxSupervisor, JaxFailure,
                         tmp_path / "j", fail_at=fail_at, torch_side=False)
    assert ours.metrics_history == theirs.metrics_history
    assert (ours.steps_run, ours.restarts, ours.final_step) == \
        (theirs.steps_run, theirs.restarts, theirs.final_step)


def test_straggler_watchdog():
    st = StragglerStats()
    flagged = 0
    for i in range(20):
        flagged += int(st.update(i, 0.1 + (5.0 if i == 15 else 0.0)))
    assert flagged == 1
    assert st.flagged[0]["step"] == 15


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_bitwise(tmp_path):
    JaxManager(str(tmp_path), async_write=False).save(
        3, _jax_tree(), {"data": {"step": 3, "seed": 0}})
    like = _torch_tree()
    got, extra = CheckpointManager(str(tmp_path)).restore(3, like)
    assert extra == {"data": {"step": 3, "seed": 0}}
    _assert_same_as_jax(got, _jax_tree())
    _assert_bitwise(got, like)


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    CheckpointManager(str(tmp_path), async_write=False).save(
        3, _torch_tree(), {"data": {"step": 3, "seed": 0}})
    got, extra = JaxManager(str(tmp_path)).restore(3, _jax_tree())
    assert extra == {"data": {"step": 3, "seed": 0}}
    _assert_same_as_jax(_torch_tree(), got)


def test_manifests_and_arrays_equal(tmp_path):
    extra = {"data": {"step": 7, "seed": 1}, "step": 7}
    JaxManager(str(tmp_path / "j"), async_write=False).save(
        7, _jax_tree(), extra)
    CheckpointManager(str(tmp_path / "t"), async_write=False).save(
        7, _torch_tree(), extra)
    dj, dt = tmp_path / "j" / "step_000000007", tmp_path / "t" / \
        "step_000000007"
    assert (dj / "manifest.json").read_text() == \
        (dt / "manifest.json").read_text()
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    for name in os.listdir(dj):
        assert (dj / name).read_bytes() == (dt / name).read_bytes(), name


# ---------------------------------------------------------------------------
# the elastic path
# ---------------------------------------------------------------------------

def _mesh(data, model, d, m):
    """A rank's view of a (data, model) mesh: what ``local_slice`` and
    ``restore`` read (no process group)."""
    return Mesh({"data": data, "model": model}, {"data": d, "model": m},
                None, tuple(range(model)), torch.device(CPU))


def test_restore_takes_each_ranks_slice(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm_params
    params = init_lm_params(get_config("stablelm-3b").reduced(), 0,
                            device=CPU)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, params)
    for data, model in ((1, 2), (2, 2), (1, 1)):
        specs = sh.param_specs(params, _mesh(data, model, 0, 0))
        for d in range(data):
            for m in range(model):
                mesh = _mesh(data, model, d, m)
                want = sh.shard_tree(params, specs, mesh)
                got, _ = cm.restore(1, want, specs, mesh)
                _assert_bitwise(got, want)
