"""Run one cell of the PyTorch port's benchmark once, from the root of a
checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/harness.py``. Exits 2 without the CUDA devices the cell
needs, printing no result.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
