"""The port's production dry-run against the JAX package's:
``n_params(active_only=True)``, the config registry, ``production_cfg``
/ ``input_specs``, ``parallel.hlo``'s collective bytes and roofline,
per-device argument bytes against XLA's ``memory_analysis()``, and one
production cell of each kind traced through ``main``.

The reference's ``launch/dryrun.py`` sets 512 placeholder devices when
it is imported, and the port's traces run on a fake process group, so
both run in subprocesses (one per package, once per module): the xdist
workers share the JAX backend and the files a gloo test writes.
Tolerance: none -- counts, shapes and bytes are compared exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import ASSIGNED_ARCHS as J_ARCHS  # noqa: E402
from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.parallel import hlo as JH  # noqa: E402

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES,  # noqa: E402
                                 all_configs, get_config)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.parallel import hlo as H  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")

# the port's exact count less the reference's approximation (see
# ArchConfig.n_params): the final norm, layernorm biases, Mamba's
# conv_b / dt_bias / D, RWKV's mixes, w0, u and ln_x, and the router
# over the padded experts (qwen2's 64 for 60) -- the same difference
# with active_only, except qwen2, whose 4 dead experts' FFNs the
# reference's total leaves out and neither counts as active
PARAM_DIFF = {  # name: (total, active)
    "qwen2-moe-a2.7b": (830670848, 198656),
    "granite-moe-1b-a400m": (1024, 1024),
    "phi3-medium-14b": (5120, 5120),
    "deepseek-coder-33b": (7168, 7168),
    "minitron-4b": (202752, 202752),
    "stablelm-3b": (168960, 168960),
    "rwkv6-1.6b": (643072, 643072),
    "musicgen-large": (200704, 200704),
    "jamba-v0.1-52b": (462848, 462848),
    "internvl2-2b": (2048, 2048),
    "gpt2-xl": (1795200, 1795200),
}

# reduced cells traced on a (2, 2) ("data", "model") mesh by both
SMALL_SHAPES = {"train": (32, 8), "prefill": (32, 8), "decode": (32, 8)}
SMALL_ARCHS = ("stablelm-3b", "granite-moe-1b-a400m")

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    from repro.launch import dryrun as D
    from repro.configs import ASSIGNED_ARCHS, SHAPES, get_config
    from repro.configs.shapes import ShapeConfig
    small_archs, small_shapes = json.loads(sys.argv[1])
    out = {"cfg": {}, "inputs": {}, "args": {}}
    for a in ASSIGNED_ARCHS + ["gpt2-xl"]:
        out["cfg"][a] = dataclasses.asdict(D.production_cfg(a))
        for s, shape in SHAPES.items():
            out["inputs"][f"{a}|{s}"] = {
                k: [list(v.shape), str(v.dtype)]
                for k, v in D.input_specs(D.production_cfg(a), shape).items()}
    import numpy as np
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    for a in small_archs:
        cfg = dataclasses.replace(get_config(a).reduced(),
                                  param_dtype="bfloat16",
                                  compute_dtype="bfloat16", pad_vocab_to=128)
        for kind, (S, B) in small_shapes.items():
            low = D.lower_cell(cfg, ShapeConfig(kind, S, B, kind), mesh,
                               microbatches=1)
            ma = low.compile().memory_analysis()
            out["args"][f"{a}|{kind}"] = int(ma.argument_size_in_bytes)
    print(json.dumps(out))
""")

_PORT_ARGS = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.launch import dryrun as D
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    small_archs, small_shapes = json.loads(sys.argv[1])
    out = {}
    with D.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="meta")
        for a in small_archs:
            cfg = dataclasses.replace(get_config(a).reduced(),
                                      param_dtype="bfloat16",
                                      compute_dtype="bfloat16",
                                      pad_vocab_to=128)
            for kind, (S, B) in small_shapes.items():
                tr = D.trace_cell(cfg, ShapeConfig(kind, S, B, kind), mesh,
                                  microbatches=1)
                out[f"{a}|{kind}"] = tr.argument_bytes
        # a train cell with grouped remat, through calibrated_costs and
        # traced directly
        cfg = dataclasses.replace(get_config("stablelm-3b").reduced(),
                                  n_layers=4, remat_group=2,
                                  param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
        shape = ShapeConfig("train", 32, 16, "train")
        out["costs"] = D.calibrated_costs(cfg, shape, mesh, microbatches=4)
        tr = D.trace_cell(cfg, shape, mesh, microbatches=4)
        out["trace"] = dict(
            flops=tr.flops, hbm_bytes=tr.hbm_bytes,
            argument_bytes=tr.argument_bytes, temp_bytes=tr.temp_bytes,
            output_bytes=tr.output_bytes,
            coll=D.H.collective_bytes(tr.log))
    print(json.dumps(out))
""")

_PORT_CELLS = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun as D
    out = {}
    for a, s in json.loads(sys.argv[1]):
        path = f"{sys.argv[2]}/{a}_{s}.json"
        rc = D.main(["--arch", a, "--shape", s, "--json", path])
        out[f"{a}|{s}"] = [rc, json.load(open(path))]
    print(json.dumps(out))
""")

# one production cell of each kind (the cheapest to trace: rwkv6's
# recurrence runs its meta route, forward and backward)
CELLS = [("rwkv6-1.6b", "train_4k"),
         ("stablelm-3b", "prefill_32k"),
         ("rwkv6-1.6b", "decode_32k"),
         ("rwkv6-1.6b", "long_500k"),
         ("stablelm-3b", "long_500k")]


def _run(script, *argv):
    got = subprocess.run([sys.executable, "-c", script, *argv], env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    return _run(_REFERENCE, json.dumps([SMALL_ARCHS, SMALL_SHAPES]))


@pytest.fixture(scope="module")
def port_args():
    return _run(_PORT_ARGS, json.dumps([SMALL_ARCHS, SMALL_SHAPES]))


@pytest.fixture(scope="module")
def port_cells(tmp_path_factory):
    return _run(_PORT_CELLS, json.dumps(CELLS),
                str(tmp_path_factory.mktemp("dryrun")))


@pytest.mark.parametrize("name", sorted(PARAM_DIFF))
def test_n_params_active_only(name):
    cfg, ref = get_config(name), jax_config(name)
    total, active = cfg.n_params(), cfg.n_params(active_only=True)
    if cfg.moe is None:
        assert active == total
    else:
        de = cfg.moe.d_expert or cfg.d_ff
        gated = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        n_moe = cfg.n_blocks * sum(m == "moe" for _, m in cfg.pattern)
        idle = cfg.n_experts_padded - cfg.moe.top_k
        assert total - active == n_moe * gated * idle * cfg.d_model * de
    assert (total - ref.n_params(),
            active - ref.n_params(active_only=True)) == PARAM_DIFF[name]


def test_registry_matches_reference():
    assert ASSIGNED_ARCHS == list(J_ARCHS)
    assert list(all_configs()) == list(j_all_configs())
    assert "gpt2-xl" not in ASSIGNED_ARCHS


def test_production_cfg_and_input_specs_match_reference(reference):
    for a, fields in reference["cfg"].items():
        mine = dataclasses.asdict(D.production_cfg(a))
        assert json.loads(json.dumps(mine)) == fields, a
        for s, shape in SHAPES.items():
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in D.input_specs(D.production_cfg(a),
                                             shape).items()}
            assert got == reference["inputs"][f"{a}|{s}"], (a, s)


def _hlo_line(kind, nbytes, g, i):
    """One compiled-HLO collective line with an f32 result of nbytes."""
    op = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter",
          "send": "collective-permute"}[kind]
    groups = "{{" + ",".join(str(r) for r in range(g)) + "}}"
    return (f"  %c{i} = f32[{nbytes // 4}]{{0}} {op}(f32[8]{{0}} %x), "
            f"replica_groups={groups}, dimensions={{0}}")


def test_collective_bytes_match_reference_on_hlo():
    log = {("all_gather", 4096, 4): 3, ("all_reduce", 1024, 16): 2,
           ("reduce_scatter", 512, 2): 5, ("send", 256, 2): 1,
           ("recv", 256, 2): 1, ("all_gather", 64, 16): 1}
    lines, i = [], 0
    for (kind, nbytes, g), n in log.items():
        if kind == "recv":
            continue
        for _ in range(n):
            lines.append(_hlo_line(kind, nbytes, g, i))
            i += 1
    want = JH.collective_bytes("\n".join(lines))
    got = H.collective_bytes(log)
    assert {k: got[k] for k in want} == want
    assert got["broadcast"] == 0
    assert want["all-gather"] == 3 * 1024 + 4


def test_roofline_arithmetic():
    rl = H.roofline(989e12, 2 * 3.35e12, {"all-reduce": int(450e9)})
    assert (rl.t_compute, rl.t_memory, rl.t_collective) == (1.0, 2.0, 1.0)
    assert rl.dominant == "memory" and rl.bound == 2.0
    assert rl.fraction(989e12) == 0.5
    assert (H.PEAK_FLOPS, H.HBM_BW, H.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_argument_bytes_match_xla(reference, port_args):
    """This rank's params, optimizer or decode state and batch rows:
    equal to XLA's ``argument_size_in_bytes`` of the reference's
    compiled cell, byte for byte."""
    for key, want in reference["args"].items():
        assert port_args[key] == want, key


def test_calibrated_costs_is_the_whole_trace(port_args):
    """``calibrated_costs`` of a train cell (grouped remat, 4
    microbatches) is its whole trace's counts, with the memory in the
    reference's keys: the trace runs every layer, nothing is
    extrapolated."""
    got, tr = port_args["costs"], port_args["trace"]
    assert (got["flops"], got["hbm_bytes"]) == (tr["flops"],
                                                tr["hbm_bytes"])
    assert got["coll_detail"] == {k: v for k, v in tr["coll"].items() if v}
    assert got["coll_bytes"] == sum(tr["coll"].values()) > 0
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == tr["argument_bytes"]
    assert mem["temp_size_in_bytes"] == tr["temp_bytes"]
    assert mem["output_size_in_bytes"] == tr["output_bytes"]
    assert mem["total_gib"] == (tr["argument_bytes"]
                                + tr["temp_bytes"]) / 2 ** 30


@pytest.mark.parametrize("cell", CELLS, ids=["|".join(c) for c in CELLS])
def test_production_cell_through_main(port_cells, cell):
    rc, results = port_cells["|".join(cell)]
    assert rc == 0
    (res,) = results
    if cell[1] == "long_500k" and cell[0] == "stablelm-3b":
        assert res["status"] == "skipped"
        return
    assert res["status"] == "ok"
    keys = {"arch", "shape", "status", "mesh", "multi_pod", "lower_s",
            "compile_s", "bytes_per_device_gib", "flops_per_device",
            "hbm_bytes_per_device", "collective_bytes", "collective_detail",
            "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "model_flops_per_device", "useful_flops_ratio",
            "roofline_fraction"}
    assert set(res) == keys
    assert res["mesh"] == [16, 16]
    assert res["flops_per_device"] > res["model_flops_per_device"] > 0
    assert 0 < res["roofline_fraction"] < 1
    assert res["bytes_per_device_gib"] > 0
    assert res["collective_bytes"] > 0
