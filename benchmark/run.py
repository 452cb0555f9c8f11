"""Run one benchmark cell once and print its result as the last line.

  python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA card(s) the cell asks for; without them it exits with 2 and
prints no result. Build and kernel caches stay in fixed directories of the
checkout (``build/``).
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(_ROOT / "build" / "bench_cache" / _sub)
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], _T0))
