"""Fixed locations inside the checkout for files made at run time.

Everything under ``BUILD_DIR`` is generated (compile cache, synthetic input
tables) and listed in ``.gitignore``.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, "build")
