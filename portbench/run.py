"""Run one benchmark cell once; see ``portbench/lib/harness.py``.

    python3 portbench/run.py --workload i3d_r50.dense --seed 7 --seconds 10 --trace 0
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.lib.harness import main

    sys.exit(main())
