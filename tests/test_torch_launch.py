"""The port's launch scripts and examples (``launch/*_torch.sh``,
``mjvideo_tpu_torch/examples/playground.py`` and ``make_sample_data.py``):
each script is valid bash, every command of the port's CLIs in them parses
with that CLI's own argparse, none of them names a module of the JAX
package, and the playground's tiny demo runs on the CPU.  The hermetic end
to end run of ``reproduce_torch.sh`` is ``test_torch_launch_hermetic.py``
(marked slow)."""

import importlib
import re
import shlex
import subprocess
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = ("train_all_stages_torch.sh", "eval_all_benchmarks_torch.sh",
           "reproduce_torch.sh")
EXAMPLES = ("playground.py", "make_sample_data.py")
# Shell values that the CLIs check against their choices.
VALUES = {"flag": "internvl-chat"}


def _commands(script: str):
    """(module, argv) of every port CLI run in ``script``: the lines
    joined at their continuations, each ``-m mjvideo_tpu_torch.<module>``
    command, and each call of the reproduce script's ``run`` helper (the
    eval CLI's), with the shell's expansions replaced by placeholders."""
    text = (REPO / "launch" / script).read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#"):
            continue
        line = re.sub(r'"\$\{\w+\[@\]\}"|"\$@"', "", line)
        line = re.sub(r"\$\{(\w+)[^}]*\}|\$(\w+)",
                      lambda m: VALUES.get(m.group(1) or m.group(2), "X"),
                      line)
        m = re.search(r"-m (mjvideo_tpu_torch\.[\w.]+)(.*)", line)
        if m and "|" not in m.group(2).split("--results")[0]:
            out.append((m.group(1), shlex.split(m.group(2).split("|")[0])))
        elif line.startswith("run ") and "()" not in line:
            out.append(("mjvideo_tpu_torch.eval.cli",
                        shlex.split(line)[2:] + ["--results", "X"]))
    return out


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_is_valid_bash(script):
    subprocess.run(["bash", "-n", str(REPO / "launch" / script)],
                   check=True)


@pytest.mark.parametrize("script", SCRIPTS)
def test_every_port_command_parses_with_its_cli(script):
    """Each command's arguments through its CLI's ``build_parser``: a
    renamed or dropped option fails here, not in a user's run."""
    commands = _commands(script)
    assert len(commands) >= {"train_all_stages_torch.sh": 3,
                             "eval_all_benchmarks_torch.sh": 4,
                             "reproduce_torch.sh": 8}[script]
    for module, argv in commands:
        if module == "mjvideo_tpu_torch.eval.cli" and "--benchmark" not in \
                argv:
            continue  # the ``run`` helper's own line: its arguments below
        parser = importlib.import_module(module).build_parser()
        args = parser.parse_args(argv)
        if hasattr(args, "device") and "--device" in argv:
            assert args.device in ("X", "cpu")


@pytest.mark.parametrize("path", [f"launch/{s}" for s in SCRIPTS] + [
    f"mjvideo_tpu_torch/examples/{e}" for e in EXAMPLES])
def test_no_script_or_example_names_the_jax_package(path):
    text = (REPO / path).read_text()
    assert not re.search(r"\bmjvideo_tpu\.(?!_)|\bmjvideo_tpu\b(?!_)"
                         r"(?=[ ./:])", text.replace("mjvideo_tpu_torch",
                                                     "")), path
    assert not re.search(r"^\s*(import|from) jax\b", text, re.M), path


def test_playground_tiny_demo_runs_on_the_cpu(capsys):
    from mjvideo_tpu_torch.examples import playground

    out = playground.main(["--device", "cpu"])
    assert isinstance(out["chat"], str)
    assert np.isfinite(out["score"]) and all(np.isfinite(out["pair"]))
    assert "reward score" in capsys.readouterr().out


def test_make_sample_data_writes_the_records(tmp_path):
    from mjvideo_tpu_torch.examples import make_sample_data

    make_sample_data.main(["--out", str(tmp_path), "--pairs", "1"])
    import json

    pairs = json.loads((tmp_path / "pairs.json").read_text())
    assert len(pairs) == 1 and (tmp_path / "videos" / pairs[0][
        "video_0_path"]).exists()
    assert len(json.loads((tmp_path / "safesora.json").read_text())) == 1
