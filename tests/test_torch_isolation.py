"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro`` (the planner, the driver and
the checkpoint store included, also once the planner has shape-evaluated a
dense model, the two moe models, the second with the mla kind, the vlm and
the encdec model, the examples, and the dry run and the mesh descriptions,
after a dry-run row, and the launcher's one-process-a-stage path with its
pipe group and transport), the serving and training
entry points do not carry on on the CPU when the card they ask for is
missing, and the training launcher takes every schedule of the JAX
launcher when the CPU is asked for."""

import functools
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s+import\b))", re.M)


def test_imports_pull_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.interop, chip_smoke\n"
        "import repro_torch.launch.train, repro_torch.core.planner, repro_torch.core.memory\n"
        "import repro_torch.runtime, repro_torch.checkpoint, repro_torch.optim.sharding\n"
        "from repro_torch.core.planner import fixed_state_bytes\n"
        "from repro_torch.configs import get_reduced\n"
        "fixed_state_bytes(get_reduced('internlm2_1_8b'), 4, 2)\n"
        "import repro_torch.configs.qwen2_moe_a2_7b, repro_torch.models.serve\n"
        "fixed_state_bytes(get_reduced('qwen2_moe_a2_7b'), 2, 2)\n"
        "import repro_torch.configs.deepseek_v3_671b\n"
        "fixed_state_bytes(get_reduced('deepseek_v3_671b'), 2, 2)\n"
        "fixed_state_bytes(get_reduced('llava_next_mistral_7b'), 2, 2)\n"
        "fixed_state_bytes(get_reduced('whisper_tiny'), 2, 2)\n"
        "import repro_torch.kernels.slstm_scan\n"
        "fixed_state_bytes(get_reduced('xlstm_350m'), 3, 2)\n"
        "fixed_state_bytes(get_reduced('recurrentgemma_9b'), 2, 2)\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.serve_pipeline\n"
        "import repro_torch.examples.straggler_replan, repro_torch.examples.train_100m\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh, repro_torch.core.p2p\n"
        "repro_torch.launch.dryrun.dryrun_cell('xlstm_350m', 'train_4k', reduced=True, p=3, m=3,\n"
        "                                      seq_len=16, verbose=False)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


def test_pipe_rank_path_pulls_in_neither_jax_nor_repro():
    """One rank of ``--procs`` (a world of one, as torchrun starts it)
    walks the per-rank step through ``core/p2p.py`` and the relay."""
    code = (
        "import os, socket, sys\n"
        "sock = socket.socket(); sock.bind(('127.0.0.1', 0)); port = sock.getsockname()[1]\n"
        "sock.close()\n"
        "os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',\n"
        "                  MASTER_PORT=str(port))\n"
        "from repro_torch.launch import train\n"
        "res = train.main(['--arch', 'internlm2_1_8b', '--reduced', '--device', 'cpu',\n"
        "                  '--procs', '1', '--pipe-size', '1', '--m', '2', '--seq-len', '8',\n"
        "                  '--microbatch', '1', '--steps', '1', '--schedule', 'zb-h1'])\n"
        "assert len(res.losses) == 1\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout and "procs=1 transport=host" in out.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_neither_jax_nor_repro(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_scan_pattern_catches_forbidden_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.models import lm", "from repro import configs", "import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.models import lm", "import jaxtyping_x"):
        assert not FORBIDDEN.search(line), line


def test_serve_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--pipe-size", "1", "--groups", "1"])


def test_train_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "internlm2_1_8b", "--reduced", "--pipe-size", "1", "--m", "1",
                    "--steps", "1"])


def _cpu_train(schedule):
    """Losses of the launcher's reduced CPU run (2 stages, 4 microbatches)."""
    from repro_torch.launch import train

    res = train.main(["--arch", "internlm2_1_8b", "--reduced", "--device", "cpu",
                      "--pipe-size", "2", "--m", "4",
                      "--seq-len", "16", "--steps", "3", "--schedule", schedule])
    return tuple(res.losses)


_baseline_losses = functools.lru_cache(maxsize=None)(_cpu_train)


@pytest.mark.parametrize("schedule,same_as", [("zb-v", None), ("v-min", "zb-v"),
                                              ("v-half", "zb-v"), ("zb-1p", "1f1b"),
                                              ("zb-2p", "1f1b")])
def test_train_runs_the_v_and_auto_schedules(schedule, same_as, capsys):
    """The launcher takes every schedule the JAX launcher takes: finite,
    decreasing losses, equal bit for bit to those of another schedule of the
    same placement (the same weights; each (stage, chunk) sums its
    microbatches in the same order under every schedule)."""
    losses = _cpu_train(schedule)
    assert f"schedule={schedule}" in capsys.readouterr().out
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    if same_as is not None:
        assert losses == _baseline_losses(same_as)
