"""The hermetic end-to-end run of ``launch/reproduce_torch.sh`` on the CPU:
synthetic pairs, tiny random checkpoints written through the port's
``utils/export.py``, the scorer's and the InternVL judge's benchmark runs
through ``python -m mjvideo_tpu_torch.eval.cli``.  It takes minutes on the
CPU, so it is marked slow."""

import os
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_reproduce_torch_script_runs_hermetically(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="4")
    run = subprocess.run(["bash", "launch/reproduce_torch.sh", "--hermetic"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=3000)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "HERMETIC_OK" in run.stdout
    assert run.stdout.count("\n== ") + run.stdout.startswith("== ") >= 5
    assert not (REPO / "results" / "reproduce_torch").exists()
