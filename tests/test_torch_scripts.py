"""The port's launch scripts against the repository's root ``scripts/``, which
drive the JAX package.

* ``train_flagship.sh`` (``full`` and ``small``) and ``eval_flagship.sh``:
  the port's copies differ from the root scripts only in the module that
  they run. Each is run with a ``python`` first on ``PATH`` that records its
  arguments and exits 0: the two argument lists are equal but for the
  module's name, and the port's ``config_from_args`` of them gives the JAX
  package's ``to_json()`` and ``model_id()``.
* ``obtain_disp_from_depth.py``: the port's copy against the root script on
  seeded depth maps: ``depth_to_disp`` and the left-to-right translation
  give equal arrays (disparities past 255, ties in depth), and ``main()``
  over two scene folders, with the EXR reader replaced by the same arrays
  in both, writes byte-equal PNG (saturated to uint8) and ``--pfm`` files.
  In a fresh interpreter the port's copy runs ``--help`` and then ``main()``
  on an empty root, and loads no module of JAX or the JAX package.

No JAX compile; a few seconds of one worker.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config as tconfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import imageio as tio
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import config as jconfig
from test_torch_imports import BANNED

ROOT = Path(__file__).resolve().parents[1]
JAX_CLI = "pmt_learning_for_semantic_segmentation_and_disparity_tpu.cli.train"
PORT_CLI = "pmt_learning_for_semantic_segmentation_and_disparity_torch.cli.train"
PORT_SCRIPTS = ROOT / "pmt_learning_for_semantic_segmentation_and_disparity_torch" / "scripts"
SCRIPTS = {"jax": ROOT / "scripts", "port": PORT_SCRIPTS}
# script, its arguments after the dataset directory
RUNS = {"train full": ("train_flagship.sh", ["full"]), "train small": ("train_flagship.sh", ["small"]),
        "eval": ("eval_flagship.sh", ["results/flagship"])}


@pytest.mark.parametrize("name", ["train_flagship.sh", "eval_flagship.sh"])
def test_port_script_is_the_root_script_with_the_port_module(name):
    jax_text = (SCRIPTS["jax"] / name).read_text()
    assert jax_text.count(JAX_CLI) == 1
    assert (SCRIPTS["port"] / name).read_text() == jax_text.replace(JAX_CLI, PORT_CLI)


def recorded_argv(script: Path, args, tmp: Path) -> list:
    """The arguments ``script`` hands ``python``, run by bash in ``tmp`` with
    a ``python`` first on ``PATH`` that writes them one a line and exits 0."""
    shim = tmp / "bin"
    shim.mkdir(exist_ok=True)
    (shim / "python").write_text('#!/bin/sh\nprintf \'%s\\n\' "$@" > "$ARGV_OUT"\n')
    (shim / "python").chmod(0o755)
    out = tmp / f"argv_{script.parent.name}_{script.name}.txt"
    env = {**os.environ, "PATH": f"{shim}{os.pathsep}{os.environ['PATH']}", "ARGV_OUT": str(out)}
    proc = subprocess.run(["bash", str(script), str(tmp / "data"), *args], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return out.read_text().splitlines()


@pytest.mark.parametrize("run", sorted(RUNS))
def test_scripts_pass_the_jax_argv_to_the_port(run, tmp_path):
    name, args = RUNS[run]
    jax_argv, port_argv = (recorded_argv(SCRIPTS[who] / name, args, tmp_path) for who in ("jax", "port"))
    assert jax_argv[:2] == ["-m", JAX_CLI] and port_argv[:2] == ["-m", PORT_CLI]
    assert port_argv[2:] == jax_argv[2:]
    flags = port_argv[2:]
    data = str(tmp_path / "data") + ("/reduced_size" if run == "train small" else "")
    assert f"{data}/colorL_{'test' if run == 'eval' else 'train'}{'__small' if run == 'train small' else ''}.txt" in flags
    got, ref = tconfig.config_from_args(flags), jconfig.config_from_args(flags)
    assert got.to_json() == ref.to_json()
    assert got.model_id() == ref.model_id()
    assert not got.parallel.bf16 and got.run.train == (run != "eval")


def load_script(who: str):
    spec = importlib.util.spec_from_file_location(f"obtain_disp_{who}",
                                                  SCRIPTS[who] / "obtain_disp_from_depth.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seeded_depths(seed: int = 0, hw=(24, 40)) -> dict:
    """Depth maps of two scenes: metres 0.5-8 (disparities up to ~494 px,
    past uint8's 255 below 0.97 m), with a repeated depth in each map so the
    farthest-first scatter meets ties."""
    rng = np.random.default_rng(seed)
    maps = {}
    for name in ("depth0001_L.exr", "depth0001_R.exr", "depth0002_L.exr"):
        z = rng.uniform(0.5, 8.0, hw).astype(np.float32)
        z[3, 5:12] = z[3, 4]
        maps[name] = z
    return maps


def test_obtain_disp_arrays_match_the_root_script():
    jax_mod, port_mod = load_script("jax"), load_script("port")
    for z in seeded_depths().values():
        disp = port_mod.depth_to_disp(z)
        np.testing.assert_array_equal(disp, jax_mod.depth_to_disp(z))
        assert disp.max() > 255
        with np.errstate(invalid="ignore"):
            np.testing.assert_array_equal(port_mod.translate_left_to_right(disp, z),
                                          jax_mod.translate_left_to_right(disp, z))


@pytest.mark.parametrize("pfm", [False, True])
def test_obtain_disp_main_writes_the_root_scripts_files(pfm, tmp_path, monkeypatch):
    maps = seeded_depths(seed=1)
    written = {}
    for who in ("jax", "port"):
        module = load_script(who)
        root = tmp_path / who
        for name in maps:
            scene = root / f"scene{name[5:9]}"
            scene.mkdir(parents=True, exist_ok=True)
            (scene / name).write_bytes(b"")
        monkeypatch.setattr(module, "read_exr_depth", lambda path: maps[os.path.basename(path)])
        monkeypatch.setattr(sys, "argv", ["obtain_disp_from_depth.py", str(root)] + ["--pfm"] * pfm)
        module.main()
        written[who] = {str(p.relative_to(root)): p.read_bytes()
                        for p in sorted(root.rglob("*")) if p.suffix in (".png", ".pfm")}
    assert written["port"] == written["jax"]
    names = sorted(written["port"])
    assert len(names) == len(maps) * (1 + pfm)
    for name in maps:
        out = tmp_path / "port" / f"scene{name[5:9]}" / name.replace("depth", "disp").replace(".exr", ".png")
        disp = load_script("port").depth_to_disp(maps[name])
        png = tio.read_image(str(out))
        assert png.dtype == np.uint8 and png.max() == 255 and (png == 255).sum() == (disp >= 254.5).sum()
        if pfm:
            got, _ = tio.read_pfm(str(out.with_suffix(".pfm")))
            np.testing.assert_array_equal(got, disp.astype(np.float32))


def test_obtain_disp_loads_no_jax(tmp_path):
    script = PORT_SCRIPTS / "obtain_disp_from_depth.py"
    code = (
        "import runpy, sys\n"
        f"for argv in ([{str(script)!r}, '--help'], [{str(script)!r}, {str(tmp_path)!r}]):\n"
        "    sys.argv = argv\n"
        "    try:\n"
        f"        runpy.run_path({str(script)!r}, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        f"banned = {BANNED!r}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "assert 'pmt_learning_for_semantic_segmentation_and_disparity_torch.data.imageio' in sys.modules\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "usage: obtain_disp_from_depth.py" in proc.stdout
