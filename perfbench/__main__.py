"""``python3 -m perfbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (``perfbench/run.py``)."""

import sys

from perfbench.run import main

sys.exit(main())
