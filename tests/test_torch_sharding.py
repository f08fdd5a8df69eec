"""The port's sharded ops (poly/ntt.py make_sharded_ntt, poly/msm.py
make_sharded_msm, parallel/sharding.py) over gloo process groups of D = 2
and 4 ranks on the CPU, against the port's unsharded ops and host
integers, exact bytes (points compared in affine form).  The slow tier
holds the same rank outputs against the JAX package's sharded ops on its
8-device CPU mesh.

Ranks are spawned with torch.multiprocessing; each joins the group through
a file under the test's tmp_path (no port is shared between test workers)
and runs single-threaded.  The rank functions import only torch, numpy and
the port: JAX stays inside the JAX-side tests.
"""

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from zkevm_circuits_tpu_torch.crypto.curve import g1_to_affine_ints
from zkevm_circuits_tpu_torch.crypto.field import fr
from zkevm_circuits_tpu_torch.crypto.params import FR_MODULUS as R
from zkevm_circuits_tpu_torch.poly import ntt as tntt
from zkevm_circuits_tpu_torch.poly.msm import msm_many

torch.set_num_threads(2)
F = fr()
NTT_KS = (6, 7, 8)
N_ROWS = 64  # rows of the scans, the MSMs and the mesh's k = 6
COLS = 3
TAU = 0x5A4D
MESH_K, MESH_K_EXT = 6, 8


def _fe(seed, shape):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    return F.from_ints(vals).reshape(*shape, 32)


def _inputs():
    """Seeded inputs, the same in every rank and in the checks."""
    scan = _fe(5, (N_ROWS,))
    scan[7] = 0  # a zero row: the products after it are 0
    return {
        "poly": {k: _fe(10 + k, (2, 1 << k)) for k in NTT_KS},
        "scan": scan,
        "scalars": _fe(6, (COLS, N_ROWS)),  # plain bytes < r
        "coeffs": _fe(7, (COLS, 1 << MESH_K)),
        "ext": _fe(8, (2, 1 << MESH_K_EXT)),
    }


def run_ranks(fn, world: int, tmp_path) -> list:
    """Spawn `world` ranks of fn(rank, world, init_method, out_dir) and
    return what each pickled to out_dir/rank<r>.pkl."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    mp.spawn(fn, args=(world, f"file://{tmp_path}/store", str(tmp_path)),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _ops_rank(rank, world, init, out_dir):
    from zkevm_circuits_tpu_torch.parallel import sharding
    from zkevm_circuits_tpu_torch.poly.msm import make_sharded_msm
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        g = dist.group.WORLD
        inp = _inputs()
        res = {}
        for k in NTT_KS:
            x = torch.as_tensor(inp["poly"][k])
            res[f"ntt{k}"] = tntt.make_sharded_ntt(g, k)(x).numpy()
            res[f"intt{k}"] = tntt.make_sharded_ntt(g, k, inverse=True)(x).numpy()
        scan = torch.as_tensor(inp["scan"])
        res["prefix_product"] = sharding.make_sharded_prefix_product(g)(scan).numpy()
        res["prefix_sum"] = sharding.make_sharded_prefix_sum(g)(scan).numpy()
        srs = Srs.unsafe_setup(MESH_K, tau=TAU, device="cpu")
        scal = torch.as_tensor(inp["scalars"])
        res["commit"] = g1_to_affine_ints(
            sharding.make_sharded_commit(g)(srs.g1_powers, scal))
        res["msm"] = g1_to_affine_ints(
            make_sharded_msm(g)(srs.g1_powers, scal[0]))
        pm = sharding.ProverMesh(g, MESH_K, MESH_K_EXT, srs)
        res["pm_intt"] = pm.intt(torch.as_tensor(inp["coeffs"])).numpy()
        ext = torch.as_tensor(inp["ext"])
        res["pm_coset_ntt_ext"] = pm.coset_ntt_ext(ext).numpy()
        res["pm_coset_intt_ext"] = pm.coset_intt_ext(ext).numpy()
        res["pm_commit_affine"] = pm.commit_affine(torch.as_tensor(inp["coeffs"][0]))
        res["pm_prefix"] = pm.exclusive_prefix_product(scan, 40, N_ROWS).numpy()
        try:
            sharding.check_backend(g, "cuda")
            res["backend_check"] = "no error"
        except ValueError as e:
            res["backend_check"] = str(e)
        try:
            sharding.ProverMesh(g, 1, 3, srs)
            res["layout_check"] = "no error"
        except AssertionError as e:
            res["layout_check"] = str(e)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, run_ranks(_ops_rank, world, tmp_path_factory.mktemp(f"ops{world}"))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.mark.parametrize("name", ["ntt", "intt"])
@pytest.mark.parametrize("k", NTT_KS)
def test_sharded_ntt_matches_ntt(ranks, inputs, k, name):
    want = getattr(tntt, name)(torch.as_tensor(inputs["poly"][k]), k).numpy()
    for res in ranks[1]:
        assert np.array_equal(res[f"{name}{k}"], want)


def _host_prefixes(digits):
    """Exclusive prefix products and sums of Montgomery rows, host ints."""
    xs = F.to_ints(digits)
    rinv = pow(F.R, -1, R)
    prod, tot, prods, sums = 1, 0, [], []
    for x in xs:
        prods.append(prod * F.R % R)
        sums.append(tot)
        prod = prod * x * rinv % R
        tot = (tot + x) % R
    return F.from_ints(prods), F.from_ints(sums)


def test_sharded_prefix_scans_match_host_ints(ranks, inputs):
    prods, sums = _host_prefixes(inputs["scan"])
    for res in ranks[1]:
        assert np.array_equal(res["prefix_product"], prods)
        assert np.array_equal(res["prefix_sum"], sums)


def test_prover_mesh_prefix_product_masks_rows(ranks, inputs):
    scan = inputs["scan"].copy()
    scan[40:] = F.ONE_MONT
    prods, _ = _host_prefixes(scan)
    for res in ranks[1]:
        assert np.array_equal(res["pm_prefix"], prods)


@pytest.fixture(scope="module")
def srs_points():
    from zkevm_circuits_tpu_torch.poly.kzg import Srs

    return Srs.unsafe_setup(MESH_K, tau=TAU, device="cpu")


def test_sharded_commit_and_msm_match_msm(ranks, inputs, srs_points):
    want = g1_to_affine_ints(
        msm_many(srs_points.g1_powers, torch.as_tensor(inputs["scalars"])))
    for res in ranks[1]:
        assert res["commit"] == want
        assert res["msm"] == want[:1]


@pytest.mark.parametrize("op", ["pm_intt", "pm_coset_ntt_ext", "pm_coset_intt_ext"])
def test_prover_mesh_transforms_match_unsharded(ranks, inputs, op):
    if op == "pm_intt":
        want = tntt.intt(torch.as_tensor(inputs["coeffs"]), MESH_K)
    elif op == "pm_coset_ntt_ext":
        want = tntt.coset_ntt(torch.as_tensor(inputs["ext"]), MESH_K_EXT)
    else:
        want = tntt.coset_intt(torch.as_tensor(inputs["ext"]), MESH_K_EXT)
    for res in ranks[1]:
        assert np.array_equal(res[op], want.numpy())


def test_prover_mesh_commit_has_no_host_shortcut(ranks, inputs, srs_points):
    """ProverMesh.commit_affine goes through the sharded MSM at test size
    too, and equals the single-device commitment."""
    want = srs_points.commit_affine(torch.as_tensor(inputs["coeffs"][0]))
    for res in ranks[1]:
        assert res["pm_commit_affine"] == want


def test_mesh_checks_backend_and_layout(ranks):
    world = ranks[0]
    for res in ranks[1]:
        assert "gloo process group cannot carry cuda" in res["backend_check"]
        assert f"n/D >= D (k=1, D={world})" in res["layout_check"]


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("k1,k2", [(1, 5), (3, 3), (4, 3)])
def test_four_step_ntt_local_matches_ntt(k1, k2, inverse):
    k = k1 + k2
    x = _fe(30 + k, (1 << k,))
    got = tntt.four_step_ntt_local(torch.as_tensor(x).reshape(1 << k1, 1 << k2, 32),
                                   k, inverse)
    want = (tntt.intt if inverse else tntt.ntt)(torch.as_tensor(x), k)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# slow tier: the same rank outputs against the JAX package's sharded ops
# ---------------------------------------------------------------------------
def _jax_mesh(world):
    import jax

    return jax.make_mesh((world,), ("rows",))


@pytest.mark.slow
def test_sharded_ops_match_jax_sharded_ops(ranks, inputs):
    import jax.numpy as jnp

    from zkevm_circuits_tpu.crypto.curve import g1_to_affine_ints as jaffine
    from zkevm_circuits_tpu.parallel import sharding as jsh
    from zkevm_circuits_tpu.poly import ntt as jntt
    from zkevm_circuits_tpu.poly.kzg import Srs as JSrs
    from zkevm_circuits_tpu.poly.msm import make_sharded_msm as jmsm

    world, results = ranks
    mesh = _jax_mesh(world)
    res = results[0]
    for k in NTT_KS:
        for name, inverse in (("ntt", False), ("intt", True)):
            fn = jntt.make_sharded_ntt(mesh, "rows", k, inverse=inverse)
            want = np.stack([np.asarray(fn(jnp.asarray(col)))
                             for col in inputs["poly"][k]])
            assert np.array_equal(res[f"{name}{k}"], want), (name, k)
    scan = jnp.asarray(inputs["scan"])
    assert np.array_equal(res["prefix_product"],
                          np.asarray(jsh.make_sharded_prefix_product(mesh, "rows")(scan)))
    assert np.array_equal(res["prefix_sum"],
                          np.asarray(jsh.make_sharded_prefix_sum(mesh, "rows")(scan)))
    pts = JSrs.unsafe_setup(MESH_K, tau=TAU).g1_powers
    scal = jnp.asarray(inputs["scalars"])
    assert res["commit"] == jaffine(jsh.make_sharded_commit(mesh, "rows")(pts, scal))
    assert res["msm"] == jaffine(jmsm(mesh, "rows")(pts, scal[0]))
