"""Helpers for the AWQ parity tests (tests/test_torch_awq*.py): every grid
search of an AWQ run recorded in both packages, and the rule that holds the
port's picks and packed weights to the JAX package's.

The JAX package runs eagerly here (``jax.disable_jit``). Its jitted block
program lets XLA rewrite the quantizer's divisions (by 15, by the group
scale) into products with a reciprocal, which rounds codes at exact
half-way points the other way and so moves clip picks against its own
eager run (ROADMAP C, known divergences); the port divides in IEEE, as the
eager JAX package does.

Both packages take the mean |activation| over the tokens as f32 sums in
other orders and raise it to the grid's powers with other ``pow``s, so a
scale vector differs by a few ulps; a weight folded with it can round to
the other bf16 (or f32) neighbour. The clip loss jumps at such ulps: a group
clipped at both ends has its zero point at round(7.5), so an ulp of its
bound moves every code of the group, and a clip pick can move at any loss
gap. The rule, per search in call order:

- a scale search picks the same grid point in both packages, or the two
  picks' losses lie within ``SCALE_GAP`` of each other (relative); the JAX
  scales equal the port's candidate at that point within CANDIDATE_TOL;
- a clip search picks the same point per (group, channel), the bounds
  within CANDIDATE_TOL; a pick may differ only where the port's
  ``search_clip`` on the JAX search's own inputs returns the JAX bounds
  exactly: the difference then comes from the inputs' rounding, not from
  the search.

The folds and packs are compared with the JAX package's grid choices
imposed on the port (``recorded(impose=True)``: each port search records
its own result and returns the JAX one): given the same choices, every
folded norm, scaled float weight and packed code is byte-equal, and the
activations handed to the next block agree within the forward's rounding.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import torch

import quick_tpu.quantize.awq as jawq
import quick_tpu_torch.quantize.awq as tawq

SCALE_GAP = 1e-3
#: a scale vector or clip bound of the JAX package against the port's at the
#: same grid point, relative to its largest element (a few f32 ulps of a mean
#: over the block's tokens, raised to a power); INPUT_TOL where the block's
#: inputs differ by the rounding of the blocks before it
CANDIDATE_TOL = 1e-5
INPUT_TOL = 1e-3
_SEARCH_CLIP = tawq.search_clip  # unwrapped, for replays


def to_torch(a) -> torch.Tensor:
    """A JAX array as a tensor of its dtype (bf16 through its bits)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@contextlib.contextmanager
def recorded(monkeypatch, impose: bool = False):
    """(jax, port): every search_scale / search_clip of either package
    inside the block as (kind, (a, b, args, kwargs), output); the port's
    also carry its ``SearchRecord``. With ``impose`` (the JAX run first),
    the port's k-th search records its own result and returns the JAX
    package's k-th scales or bounds."""
    jrec, prec = [], []

    def wrap(mod, out, kind):
        orig = getattr(mod, f"search_{kind}")

        def run(a, b, *args, **kw):
            res = orig(a, b, *args, **kw)
            out.append((kind, (a, b, args, kw), res))
            if impose and mod is tawq:
                return to_torch(jrec[len(out) - 1][2])
            return res
        monkeypatch.setattr(mod, f"search_{kind}", run)

    for kind in ("scale", "clip"):
        wrap(jawq, jrec, kind)
        wrap(tawq, prec, kind)
    with tawq.recorded_searches() as losses:
        yield jrec, prec
    prec[:] = [p + (r,) for p, r in zip(prec, losses)]


def jax_pick(kind: str, jin, out, rec: "tawq.SearchRecord", tol: float) -> np.ndarray:
    """The grid point the JAX search chose: for a scale search the port's
    candidate vector nearest to its scales (asserted within ``tol``), for a
    clip search the i of its bounds = (its weights' group amax) *
    (1 - i / N_GRID)."""
    out = np.asarray(out, np.float32)
    if kind == "scale":
        cands = rec.grid.numpy()
        dist = np.abs(cands - out[None]).max(1) / np.abs(out).max()
        i = int(np.argmin(dist))
        assert dist[i] <= tol, f"the JAX scales are on no port candidate ({dist[i]})"
        return np.array(i)
    w = np.asarray(jin[0], np.float32)
    G = w.shape[0] // out.shape[0]
    om = np.abs(w).reshape(out.shape[0], G, -1).max(1)
    i = np.rint((1 - out / np.where(om > 0, om, 1)) * tawq.N_GRID).astype(np.int64)
    i = np.where(om > 0, i, 0)
    assert np.all(np.abs(om * (1 - i / tawq.N_GRID) - out) <= 1e-6 * np.abs(out).max()), \
        "a JAX clip bound is on no grid point"
    return i


def _same_inputs(jin, pin) -> bool:
    """Whether a search's inputs (x and its weights) are bit-equal in both
    packages."""
    def flat(v):
        return list(v) if isinstance(v, (list, tuple)) else [v]

    pairs = list(zip(flat(jin[0]) + flat(jin[1]), flat(pin[0]) + flat(pin[1])))
    return all(torch.equal(to_torch(a), b) for a, b in pairs)


def check_searches(jrec, prec) -> dict:
    """Hold the port's searches to the JAX package's (the module rule), the
    scales and bounds at equal picks within CANDIDATE_TOL where the
    search's inputs are bit-equal, INPUT_TOL where earlier steps' rounding
    moved them; returns the flips: {"scale": [(search, gap)], "clip":
    [(search, n)]}."""
    assert [r[0] for r in jrec] == [r[0] for r in prec], "the packages made other searches"
    flips = {"scale": [], "clip": []}
    for k, ((kind, jin, jout), (_, pin, pout, rec)) in enumerate(zip(jrec, prec)):
        tol = CANDIDATE_TOL if _same_inputs(jin, pin) else INPUT_TOL
        jp = jax_pick(kind, jin, jout, rec, tol)
        pp = rec.picks().numpy()
        differ = jp != pp
        if kind == "scale":
            if differ:
                gap = float(tawq.relative_gap(rec.losses, torch.tensor(jp), torch.tensor(pp)))
                assert gap <= SCALE_GAP, f"search {k}: scale picks differ at a loss gap {gap}"
                flips["scale"].append((k, gap))
            else:
                s, r = pout.numpy(), np.asarray(jout, np.float32)
                assert np.all(np.abs(s - r) <= tol * np.abs(r).max()), f"search {k}"
            continue
        if not differ.any():
            # a group's bound is its amax: a weight moved by rounding moves it
            # by up to one bf16 step
            b, r = pout.numpy(), np.asarray(jout, np.float32)
            step = 0.0 if tol == CANDIDATE_TOL else 2.0 ** -7
            assert np.all(np.abs(b - r) <= step * np.abs(r) + CANDIDATE_TOL * np.abs(r).max()), \
                f"search {k}: clip bounds"
            continue
        replay = _SEARCH_CLIP(to_torch(jin[0]), to_torch(jin[1]), *jin[2], **jin[3]).numpy()
        assert np.array_equal(replay, np.asarray(jout)), \
            f"search {k}: the port's search on the JAX inputs does not make the JAX picks"
        flips["clip"].append((k, int(differ.sum())))
    return flips


def assert_close(port: torch.Tensor, ref, tol: float, what: str = "") -> None:
    """|port - ref| <= tol * (1 + |ref|)."""
    p = port.to(torch.float32).numpy()
    r = np.asarray(ref, np.float32)
    assert p.shape == r.shape, what
    err = float((np.abs(p - r) / (1 + np.abs(r))).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def assert_params_equal(port, ref, what: str = "") -> None:
    """Walk a port params dataclass (a block, a whole model) beside the JAX
    package's: every tensor byte-equal (the rope tables and gemma3's local
    ones, rebuilt from the config, skipped)."""
    import dataclasses

    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            if f.name not in ("rope_cos", "rope_sin", "rope_cos_local", "rope_sin_local"):
                assert_params_equal(getattr(port, f.name), getattr(ref, f.name),
                                    f"{what}.{f.name}")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), what
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_params_equal(a, b, f"{what}[{i}]")
    elif isinstance(port, torch.Tensor):
        assert torch.equal(port, to_torch(ref)), what
    else:
        assert port == ref, what
