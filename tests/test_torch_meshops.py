"""The port's mesh collectives (``repro_torch.core.meshops``) and meshes
(``repro_torch.launch.mesh``) on the CPU, held against the JAX package.

The collectives run over a ``(2, 2, 2)`` ``("pod", "data", "model")``
mesh on both sides (``mesh_ranks.py``): the reference under ``shard_map``
in one subprocess over forced host devices, the port in one spawn of 8
gloo ranks; every input is in-spec over all three axes on its leading
dimension, so every rank holds other data.  The local functions
(``quantize_int8``, ``hash32``, the sampling masks) run in this process.

Tolerances.  The exchanges (ring, all-to-all, the two-level template) move
bytes and are held bit for bit.  A sum of ``n`` float32 blocks in another
order is held per element within ``(n + 1) 2^-24 sum|x|`` of the
reference's and of the exact (float64) sum; the compressed path within
that bound plus one quantisation step of the reference's (its scale,
bounded by the largest inner sum over 127), and within ``n_outer`` steps
of the exact sum.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

import mesh_ranks
from repro.core import meshops as jmeshops

torch = pytest.importorskip("torch")

from repro_torch.core import meshops  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

SEED = 25
U = 2.0 ** -24
CASES = {c[0]: c for c in mesh_ranks.meshops_cases()}
EXCHANGES = [n for n, c in CASES.items() if c[1] in ("ring", "ring8", "a2a",
                                                      "two_level")]
SUMS = [n for n, c in CASES.items() if c[1] in ("hier", "flat")] + [
    f"{n}|{leaf}" for n, c in CASES.items() if c[1] == "grad_sync"
    for leaf in ("w", "n.b")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshops")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **mesh_ranks.meshops_inputs(SEED))
    proc = mesh_ranks.start_reference(
        "reference_meshops", dict(inputs=str(inputs), out=str(tmp / "ref.npz")),
        devices=512)
    try:
        ranks = mesh_ranks.run_ranks("meshops", tmp, (str(inputs),),
                                     timeout=120)
    finally:
        mesh_ranks.finish(proc, timeout=240)
    ref = dict(np.load(tmp / "ref.npz"))
    return dict(ranks=ranks, ref=ref,
                port={k: np.concatenate([r[k] for r in ranks]) for k in ref},
                meta=json.loads((tmp / "ref.json").read_text()),
                inputs=dict(np.load(inputs)))


@pytest.mark.parametrize("case", EXCHANGES)
def test_exchanges_match_bit_for_bit(runs, case):
    got, want = runs["port"][case], runs["ref"][case]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, runs["inputs"][CASES[case][3]])


def _summed(case: str) -> tuple[np.ndarray, set, str | None]:
    """(input, the axes summed over, the compressed outer axis or None)."""
    base, _, leaf = case.partition("|")
    _, op, kw, inp = CASES[base]
    if op == "hier":
        axes = {kw["inner"]} | ({kw["outer"]} if kw["outer"] else set())
        return inp, axes, kw["outer"] if kw["compress"] else None
    if op == "flat":
        return inp, set(kw["axes"]), None
    return {"w": "g_w", "n.b": "g_b"}[leaf], {"data", "pod"}, \
        "pod" if kw["compress"] else None


def _group_sum(x: np.ndarray, axes: set) -> np.ndarray:
    """Each rank's block replaced by the sum over ``axes`` (float64)."""
    g = x.reshape(*mesh_ranks.MESH, -1).astype(np.float64)
    dims = tuple(i for i, a in enumerate(mesh_ranks.AXES) if a in axes)
    return np.broadcast_to(g.sum(dims, keepdims=True), g.shape).reshape(
        x.shape)


@pytest.mark.parametrize("case", SUMS)
def test_sums_within_the_summation_bound(runs, case):
    inp, axes, outer = _summed(case)
    x = runs["inputs"][inp]
    got, want = runs["port"][case], runs["ref"][case]
    assert got.dtype == want.dtype == np.float32 and got.shape == x.shape
    n = int(np.prod([dict(zip(mesh_ranks.AXES, mesh_ranks.MESH))[a]
                     for a in axes]))
    bound = (n + 1) * U * _group_sum(np.abs(x), axes)
    exact = _group_sum(x, axes)
    if outer is None:
        assert np.all(np.abs(got - want) <= bound)
        assert np.all(np.abs(got - exact) <= bound)
        assert np.all(np.abs(want - exact) <= bound)
        return
    inner = axes - {outer}
    step = np.abs(_group_sum(x, inner)).max() / 127 * (1 + 2 ** -20)
    assert np.all(np.abs(got - want) <= bound + step)
    assert np.all(np.abs(got - exact) <= bound + 2 * step)
    assert np.abs(got - exact).max() > 1e-3 * step      # codes, not floats


def test_sum_bound_rejects_a_dropped_rank(runs):
    """The bound is tight enough to see one rank's block left out."""
    x = runs["inputs"]["xs"]
    got = runs["port"]["flat-pod+data+model"]
    bound = 9 * U * _group_sum(np.abs(x), set(mesh_ranks.AXES))
    assert np.all(np.abs(got - _group_sum(x, set(mesh_ranks.AXES))) <= bound)
    dropped = _group_sum(np.concatenate([x[:7], 0 * x[7:]]),
                         set(mesh_ranks.AXES))
    assert np.abs(got - dropped).max() > 10 * bound.max()


def test_mesh_coordinates_and_groups(runs):
    """Row-major ranks; a tuple of axes linearised with its first axis the
    major one, whatever its order in the mesh."""
    for r, res in enumerate(runs["ranks"]):
        pod, data, model = np.unravel_index(r, mesh_ranks.MESH)
        assert res["coord"].tolist() == [pod, data, model]
        assert int(res["index-pod+model"]) == pod * 2 + model
        assert res["group-pod+model"].tolist() == [
            p * 4 + data * 2 + m for p in range(2) for m in range(2)]
        assert res["group-model+pod"].tolist() == [
            p * 4 + data * 2 + m for m in range(2) for p in range(2)]
        assert res["group-pod+data+model"].tolist() == list(range(8))


def test_a_mesh_over_the_first_ranks(runs):
    """``make_mesh((2, 2), ...)`` on 8 ranks takes ranks 0-3, row-major, as
    ``jax.devices()[:4].reshape(2, 2)``; the other ranks are outside it."""
    for r, res in enumerate(runs["ranks"]):
        if r < 4:
            d, m = divmod(r, 2)
            assert res["prefix"].tolist() == [d, m, 2 * (2 * d) + 1]
        else:
            assert res["prefix"].tolist() == [-1, -1, -1]


def test_wrong_device_raises_and_nothing_stages(runs):
    """A cuda mesh over a gloo world, and a tensor off the mesh's device,
    are refused on every rank."""
    for res in runs["ranks"]:
        assert res["refused"].tolist() == ["cuda mesh", "meta tensor"]


def test_elastic_mesh_layout_matches_reference(runs):
    assert runs["meta"]["devices"] == 512
    shapes = runs["meta"]["elastic"]
    assert len(shapes) == 4 * 3 * 49
    for n, mp, ps, want in shapes:
        try:
            shape, axes = pmesh._elastic_layout(n, mp, ps)
            got = [list(t) for t in zip(axes, shape)]
        except ValueError:
            got = "ValueError"
        assert got == want, (n, mp, ps)
    assert any(len(w) == 3 for *_, w in shapes if w != "ValueError")


# ---------------------------------------------------------------------------
# the local functions, in this process
# ---------------------------------------------------------------------------

def _keys(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2 ** 16,
             -2 ** 16, 12345]
    return np.concatenate([np.array(edges, np.int64),
                           rng.integers(-2 ** 31, 2 ** 31, 500)]
                          ).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    px = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jmeshops.quantize_int8(jx)
    pq, ps = meshops.quantize_int8(px)
    assert pq.dtype == torch.int8 and ps.dtype == px.dtype
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert float(ps) == float(js)
    np.testing.assert_array_equal(meshops.dequantize_int8(pq, ps).numpy(),
                                  np.asarray(jmeshops.dequantize_int8(jq, js)))


@pytest.mark.parametrize("seed", [0, -1])
def test_hash32_bit_for_bit(seed):
    keys = _keys(seed + 7)
    got = meshops.hash32(torch.from_numpy(keys), seed=seed)
    want = np.asarray(jmeshops.hash32(jnp.asarray(keys), seed=seed))
    assert got.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _raises(fn) -> str | None:
    try:
        fn()
    except OverflowError as e:
        return f"OverflowError: {e}"
    return None


@pytest.mark.parametrize("seed", [-3, -2, -1, 0, 1, 2, 0x5A11, 0xC0FFEE])
def test_overflow_errors_where_the_reference_raises(seed):
    """The seed's offset does not fit in uint32 for every seed but -1 and
    0: ``hash32`` raises there, with the reference's message; the two
    sampling functions hash with seeds 0xC0FFEE and 0x5A11 and raise for
    every input, as the reference's do."""
    keys = _keys(1)
    for port_fn, ref_fn in (
            (lambda: meshops.hash32(torch.from_numpy(keys), seed=seed),
             lambda: jmeshops.hash32(jnp.asarray(keys), seed=seed)),
            (lambda: meshops.sample_group_mask(torch.from_numpy(keys), 0.1,
                                               seed=seed % 100),
             lambda: jmeshops.sample_group_mask(jnp.asarray(keys), 0.1,
                                                seed=seed % 100)),
            (lambda: meshops.estimate_tokens_per_expert(
                torch.from_numpy(keys % 16), 16, 0.5, seed=seed % 100),
             lambda: jmeshops.estimate_tokens_per_expert(
                 jnp.asarray(keys % 16), 16, 0.5, seed=seed % 100))):
        assert _raises(port_fn) == _raises(ref_fn)
    assert (_raises(lambda: meshops.hash32(torch.zeros(1), seed=seed))
            is None) == (seed in (-1, 0))


def _modular_reference_hash32(x, seed=0):
    """The reference's ``hash32`` with its seed offset taken modulo 2^32."""
    z = x.astype(jnp.uint32) + jnp.uint32(
        (seed * 0x9E3779B9 + 0x9E3779B9) % 2 ** 32)
    z = (z ^ (z >> 16)) * jmeshops._C1
    z = (z ^ (z >> 13)) * jmeshops._C2
    return z ^ (z >> 16)


def test_sampling_bodies_match_with_a_modular_offset(monkeypatch):
    """Past ``hash32``'s overflow, the two sampling functions' bodies: both
    packages' offsets taken modulo 2^32, the masks and the estimates bit
    for bit."""
    keys = _keys(2)
    np.testing.assert_array_equal(
        np.asarray(_modular_reference_hash32(jnp.asarray(keys))),
        np.asarray(jmeshops.hash32(jnp.asarray(keys))))
    monkeypatch.setattr(jmeshops, "hash32", _modular_reference_hash32)
    monkeypatch.setattr(meshops, "_seed_offset",
                        lambda seed: (seed * 0x9E3779B9 + 0x9E3779B9)
                        % 2 ** 32)
    ids = np.random.default_rng(4).integers(0, 16, (4, 64)).astype(np.int32)
    for rate in (1.0, 0.5, 0.1, 0.01):
        for seed in (0, 3, 7):
            got = meshops.sample_group_mask(torch.from_numpy(keys), rate,
                                            seed=seed)
            want = jmeshops.sample_group_mask(jnp.asarray(keys), rate,
                                              seed=seed)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            got = meshops.estimate_tokens_per_expert(
                torch.from_numpy(ids), 16, rate, seed=seed)
            want = jmeshops.estimate_tokens_per_expert(
                jnp.asarray(ids), 16, rate, seed=seed)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grad_sync_refuses_unknown_mode():
    for fn in (lambda: jmeshops.grad_sync({}, inner_axis="data",
                                          outer_axis=None, mode="ring"),
               lambda: meshops.grad_sync({}, None, inner_axis="data",
                                         outer_axis=None, mode="ring")):
        with pytest.raises(ValueError, match="unknown grad sync mode 'ring'"):
            fn()


def test_mesh_needs_an_initialised_world():
    with pytest.raises(RuntimeError, match="initialised"):
        pmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
