"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on the card unless asked for the CPU
(and raise without one), and ``chip_smoke.py`` prints no result
without a card or outside a checkout."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the xdist workers already fill the CPUs, and a
# torch thread pool per worker oversubscribes them many times over
torch.set_num_threads(1)

from repro_torch.bridge import from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, greedy_reference  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_profiler_effect.py",
    REPO / "chip_mover_ab.py", REPO / "chip_mma_probe.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = get_config("gpt2-xl").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_lm_params(cfg, 0)
    params = T.init_lm_params(cfg, 0, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.forward(params, cfg, toks)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg, EngineConfig(slots=1, max_len=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_reference(params, cfg, [1, 2], 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy({"w": np.zeros(2, np.float32)})
    # asked for the CPU, they run there
    logits, _ = T.forward(params, cfg, toks, device="cpu")
    assert logits.device.type == "cpu"
    assert len(greedy_reference(params, cfg, [1, 2], 2, device="cpu")) == 2
    eng = Engine(params, cfg, EngineConfig(slots=1, max_len=16),
                 device="cpu")
    assert eng.state["index"].device.type == "cpu"


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_prints_no_result_without_a_card(tmp_path):
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:      # the script alone, without the program
            shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        out = _smoke(cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
