"""The schedule of the exact 1D tile of K1-K3 (``csrc/sg1d_exact.cuh``),
stated in Python for the tests of ``test_torch_conv.py`` and
``test_torch_padded.py``: the kernel's constants and the tiles, spans and
stored outputs that follow from them. On the card the same grid of rows
runs through the kernels themselves (the ``cuda`` tests of those files and
``chip_smoke.py``'s exact grid)."""

# Threads a block; by element size, outputs a thread and the stages of the
# ring (sg1d_exact.cuh kThreads, kQF32 / kQF64, kStagesF32 / kStagesF64).
EXACT_THREADS = 256
EXACT_Q = {4: 12, 8: 10}
EXACT_STAGES = {4: 3, 8: 2}


def exact_tile_plan(n_out: int, ws: int, off: int, row_offsets,
                    itemsize: int, blocks: int | None = None) -> dict:
    """The schedule of the exact 1D tile (``csrc/sg1d_exact.cuh``) of K1,
    K2 (``off = -n``, ``n_out = N``) and K3 (``off = 0``, ``n_out = N - ws
    + 1``) over rows whose first samples lie ``row_offsets[b]`` elements
    past a 16-byte boundary.

    Output j of a row reads the samples ``j + off + [0, ws)``. A row has
    ``tiles`` tiles of ``tile = 256 q`` outputs; tile t starts at output
    ``o0 = t tile - s``, the row's shift s in ``[0, V)`` (V = 16 /
    itemsize) putting its first staged sample ``in0 = o0 + off`` on a
    16-byte boundary, and stages the ``span`` samples ``in0 + [0, span)``;
    thread i of the block reads ``q i + [0, reads)`` of them for its q
    outputs ``o0 + q i + [0, q)``; the tile stores those in ``[0, n_out)``.
    Tiles are numbered row by row; block i of ``grid = min(tiles in all,
    blocks)`` walks the ids ``i, i + grid, ...``, the k-th of them through
    ring stage ``k mod stages``.

    Returns ``{"q", "tile", "span", "reads", "stages", "tiles", "grid",
    "shift": [s a row], "plan": [(row, o0, in0, first stored, end stored) a
    tile id], "walks": [[tile ids] a block]}``."""
    q = EXACT_Q[itemsize]
    vec = 16 // itemsize
    tile = EXACT_THREADS * q
    full = ws & ~3
    span = tile + full + 4
    tiles = -(-(n_out + vec - 1) // tile)
    shift = [(int(e) + off) % vec for e in row_offsets]
    plan = []
    for b, s in enumerate(shift):
        for t in range(tiles):
            o0 = t * tile - s
            plan.append((b, o0, o0 + off, max(o0, 0),
                         max(min(o0 + tile, n_out), 0)))
    total = len(plan)
    grid = total if blocks is None else min(total, blocks)
    return {"q": q, "tile": tile, "span": span, "reads": full + q + 4,
            "stages": EXACT_STAGES[itemsize], "tiles": tiles,
            "grid": grid,
            "shift": shift, "plan": plan,
            "walks": [list(range(i, total, grid)) for i in range(grid)]}
