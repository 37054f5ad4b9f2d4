"""The port imports neither JAX, flax nor the JAX package: checked in a
fresh interpreter and by scanning its sources and ``chip_smoke.py``."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = "pmt_learning_for_semantic_segmentation_and_disparity_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "pmt_learning_for_semantic_segmentation_and_disparity_tpu")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        f"import {PORT}, {PORT}.models, {PORT}.ops, {PORT}.metrics, {PORT}.training, {PORT}.core\n"
        f"import {PORT}.data, {PORT}.data.native, {PORT}.evaluation, {PORT}.cli.train\n"
        f"import {PORT}.utils.torch_import, {PORT}.models.aspp, {PORT}.models.hanet\n"
        f"import {PORT}.losses.edge, {PORT}.losses.multitask, {PORT}.ops.edges\n"
        f"import {PORT}.models.resnet_deeplab, {PORT}.models.efficientnet, {PORT}.models.mobilenetv3\n"
        f"import {PORT}.models.ext_small, {PORT}.models.sdnet_dlab\n"
        f"import {PORT}.models.warpnets, {PORT}.models.deeplab, {PORT}.models.psmnet\n"
        f"import {PORT}.ops.warp, {PORT}.ops.costvolume, {PORT}.evaluation.tta\n"
        f"import {PORT}.models.encdec, {PORT}.parallel, {PORT}.utils.analysis\n"
        f"import {PORT}.utils.viz, {PORT}.utils.profiling, {PORT}.parallel.mesh\n"
        f"import {PORT}.tools.overfit_smoke, {PORT}.tools.overfit_curve\n"
        f"banned = {BANNED!r}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(BANNED) + r")\b", re.M)
    files = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = {str(f.relative_to(ROOT)): pattern.findall(f.read_text()) for f in files}
    assert not {f: m for f, m in offenders.items() if m}
