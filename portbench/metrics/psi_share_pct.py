"""The CPML ψ work the kernels perform, as a share of the Yee work, in
percent: the count ``psi_cell_updates`` on the port's ``fdtd.run`` spans
(each launch's plan: every ψ stepped outside its axis's flat profile run,
over the padded cross-section) over twelve ψ a cell-update of the
window's jobs. The yardstick's floor, each ψ on its 2·npml slab cells
only, is 18.5% for the Microstrip 3D cell and 21.2% for the sweep; the
reading shows how far the kernels' skip sits above it. None where the
port counts no ψ work (MUR, PEC, or a port without the count)."""

from .. import program_spans

NAME = "psi_share_pct"
UNIT = "%"
LAYER = "run loop"
MOVES = "cell_rate"


def read(w):
    t = program_spans.totals(w)
    if not t or "fdtd.run" not in t:
        return None
    psi = t["fdtd.run"]["counts"].get("psi_cell_updates")
    cells = sum(j.cell_updates for j in w.jobs)
    if psi is None or cells <= 0:
        return None
    return 100.0 * psi / (12.0 * cells)
