"""GUI launcher with dependency checks (reference: launch_gui.py:12-141).

Counterpart of the repository's ``launch_gui.py`` for the port: verifies
the Python environment (torch and its CUDA device, matplotlib, tkinter and
a display), prints actionable messages, and starts the port's desktop GUI
on the card. Run it as::

    python -m fdtd_solver_antennas_tpu_torch.launch_gui
"""

from __future__ import annotations

import importlib
import os
import sys


def check(name: str, how_to_fix: str) -> bool:
    try:
        importlib.import_module(name)
        print(f"  [ok] {name}")
        return True
    except Exception as e:
        print(f"  [MISSING] {name}: {e}\n     → {how_to_fix}")
        return False


def main() -> int:
    print("Checking environment…")
    ok = True
    ok &= check("numpy", "pip install numpy")
    ok &= check("torch", "install a CUDA build of PyTorch")
    ok &= check("matplotlib", "pip install matplotlib")
    if not ok:
        print("Install the missing dependencies and retry.")
        return 1

    import torch

    if not torch.cuda.is_available():
        print(
            f"  [MISSING] CUDA device — torch {torch.__version__} sees no "
            "card; the GUI runs its simulations on the card.\n"
            "The CLI runs on the CPU with --device cpu "
            "(python -m fdtd_solver_antennas_tpu_torch)."
        )
        return 1
    print(f"  [ok] torch CUDA device: {torch.cuda.get_device_name(0)}")

    try:
        import tkinter  # noqa: F401
    except Exception:
        print(
            "  [MISSING] tkinter — install your OS's python3-tk package.\n"
            "Falling back: use the CLI (python -m fdtd_solver_antennas_tpu_torch)\n"
            "or the web UI (streamlit run "
            "fdtd_solver_antennas_tpu_torch/frontends/webapp.py)."
        )
        return 1
    if not os.environ.get("DISPLAY") and sys.platform.startswith("linux"):
        print(
            "  [WARN] no DISPLAY — the desktop GUI needs a display/X server.\n"
            "Use the CLI or the web UI on headless machines."
        )
        return 1

    print("Starting GUI…")
    from .frontends.gui_app import main as gui_main

    gui_main()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
