"""Port parity of the data layer (airpose_tpu_torch.data vs airpose_tpu.data
on the same numpy inputs, on the CPU): the device pipeline (crop_resize_pad
≤ 1e-5 abs against jax.image.scale_and_translate, including boxes past the
context edge, where JAX renormalizes the border columns, and non-square
boxes, where the pad mask cuts; bb_encoding and the deterministic jitter
exact; finish_batch key for key), the Prefetcher (ports of the JAX
prefetcher tests), the readers' host batches key for key on the JAX tests'
fixture writers with the same numpy Generator seed, their canonical GT
(≤ 1e-5 relative), the schema diagnostics word for word, the joint tables,
the body-only vertex mask and the mesh overlay."""

import os
import pickle
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import (_write_fake_aerialpeople, _write_fake_h36m,  # noqa: E402
                       _write_fake_totalcap)

from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic_smplx_params  # noqa: E402
from airpose_tpu.bodymodel import vertex_ids as jvertex_ids  # noqa: E402
from airpose_tpu.data import aerialpeople as jap  # noqa: E402
from airpose_tpu.data import h36m as jh36m  # noqa: E402
from airpose_tpu.data import joints as jjoints  # noqa: E402
from airpose_tpu.data import mixed as jmixed  # noqa: E402
from airpose_tpu.data import pipeline as jp  # noqa: E402
from airpose_tpu.data import totalcap as jtc  # noqa: E402
from airpose_tpu.data.validate import DbSchemaError as JDbSchemaError  # noqa: E402
from airpose_tpu.utils import render as jrender  # noqa: E402
from airpose_tpu_torch.bodymodel import smplx_params_from_numpy  # noqa: E402
from airpose_tpu_torch.bodymodel import vertex_ids as tvertex_ids  # noqa: E402
from airpose_tpu_torch.data import aerialpeople as tap  # noqa: E402
from airpose_tpu_torch.data import h36m as th36m  # noqa: E402
from airpose_tpu_torch.data import joints as tjoints  # noqa: E402
from airpose_tpu_torch.data import mixed as tmixed  # noqa: E402
from airpose_tpu_torch.data import pipeline as tp  # noqa: E402
from airpose_tpu_torch.data import totalcap as ttc  # noqa: E402
from airpose_tpu_torch.data.validate import DbSchemaError  # noqa: E402
from airpose_tpu_torch.utils import render as trender  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the tier runs six
    pytest workers on the machine's cores, and a worker whose torch uses
    every core oversubscribes them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMPLX_FIELDS = ("v_template", "shape_dirs", "pose_dirs", "j_regressor", "lbs_weights",
                "hand_pose", "extra_joint_ids", "lmk_vert_ids", "lmk_bary", "parents",
                "faces")


def port_smplx(jparams):
    """The JAX SMPLXParams as the port's, on the CPU."""
    return smplx_params_from_numpy(**{f: np.asarray(getattr(jparams, f))
                                      for f in SMPLX_FIELDS})


def assert_same_batch(got, want, atol=1e-6, rtol=1e-6):
    """Port and JAX batches key for key: the same keys, shapes and values."""
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   atol=atol, rtol=rtol, err_msg=k)


# ---- the device pipeline ----

BOXES = {
    # boxes reaching past the context (negative origin, beyond W/H): JAX
    # zeroes samples outside [−0.5, in − 0.5] and renormalizes the columns
    # that straddle the edge
    "past_edge": [[-20.0, -10.0, 100.0, 80.0], [40.0, 30.0, 150.0, 150.0],
                  [-5.5, 60.25, 140.0, 90.0]],
    # non-square boxes: the shorter side is padded and the pad mask cuts
    "non_square": [[10.0, 20.0, 60.0, 90.0], [50.0, 50.0, 120.0, 40.0],
                   [30.5, 40.25, 33.3, 77.7]],
}


@pytest.mark.parametrize("out_size", [224, 64])
@pytest.mark.parametrize("case", list(BOXES))
def test_crop_resize_pad_matches_jax(case, out_size):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 128, 128, 3)).astype(np.uint8)
    boxes = np.asarray(BOXES[case], np.float32)
    want, want_scale = jp.crop_resize_pad(jnp.asarray(img), jnp.asarray(boxes), out_size)
    got, scale = tp.crop_resize_pad(torch.from_numpy(img), torch.from_numpy(boxes), out_size)
    assert got.shape == (3, out_size, out_size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(scale.numpy(), np.asarray(want_scale), atol=0, rtol=0)
    # f32 input takes the same path without the /255
    got_f = tp.crop_resize_pad(torch.from_numpy(img).float() / 255.0,
                               torch.from_numpy(boxes), out_size)[0]
    np.testing.assert_allclose(got_f.numpy(), got.numpy(), atol=1e-6, rtol=0)


def test_bb_encoding_and_deterministic_jitter_match_jax():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(0, 400, (8, 4)).astype(np.float32)
    principal = rng.uniform(300, 900, (8, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, (8,)).astype(np.float32)
    want = jp.bb_encoding(jnp.asarray(boxes), jnp.asarray(principal), jnp.asarray(scale))
    got = tp.bb_encoding(*map(torch.from_numpy, (boxes, principal, scale)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    xy = rng.uniform(0, 300, (8, 2)).astype(np.float32)
    person = np.concatenate([xy, xy + rng.uniform(20, 200, (8, 2)).astype(np.float32)], 1)
    extent = rng.uniform(300, 700, (8, 2)).astype(np.float32)
    margin = rng.uniform(50, 250, (8,)).astype(np.float32)
    for m in (200.0, margin):
        want = jp.jitter_crop_boxes(jax.random.PRNGKey(0), jnp.asarray(person),
                                    jnp.asarray(extent), jnp.asarray(m), True)
        got = tp.jitter_crop_boxes(None, torch.from_numpy(person), torch.from_numpy(extent),
                                   torch.as_tensor(m), deterministic=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jitter_boxes_stay_inside():
    """tests/test_data.py::test_jitter_boxes_stay_inside's invariants on the
    torch.Generator draws."""
    person = torch.tensor([[300.0, 200.0, 500.0, 600.0]] * 64)
    extent = torch.tensor([[640.0, 640.0]] * 64)
    b = tp.jitter_crop_boxes(torch.Generator().manual_seed(0), person, extent, 200.0).numpy()
    assert (b[:, 0] >= 0).all() and (b[:, 1] >= 0).all()
    assert (b[:, 0] + b[:, 2] <= 640.0 + 1e-3).all()
    assert (b[:, 1] + b[:, 3] <= 640.0 + 1e-3).all()
    # window always contains the person box
    assert (b[:, 0] <= 300.0).all() and (b[:, 1] <= 200.0).all()
    assert (b[:, 0] + b[:, 2] >= 500.0).all()
    assert (b[:, 1] + b[:, 3] >= 600.0).all()
    # the draws jitter (not the deterministic maximal window), from the seed
    assert len(np.unique(b[:, 0])) > 32
    again = tp.jitter_crop_boxes(torch.Generator().manual_seed(0), person, extent, 200.0)
    np.testing.assert_array_equal(again.numpy(), b)
    det = tp.jitter_crop_boxes(None, person, extent, 200.0, deterministic=True).numpy()
    np.testing.assert_allclose(det[0], [100.0, 0.0, 540.0, 640.0])


def host_batch(B=3, S=96, context_scale=1.0, seed=2):
    """A host batch in the readers' layout: B two-view samples of S² uint8
    context, person boxes inside each window's extent."""
    rng = np.random.default_rng(seed)
    ext = rng.uniform(S // 2, S, (B, 2, 2)).astype(np.float32)
    lo = rng.uniform(0, 0.3, (B, 2, 2)).astype(np.float32) * ext
    hi = lo + rng.uniform(0.3, 0.6, (B, 2, 2)).astype(np.float32) * ext
    intr = np.tile(np.asarray([[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]], np.float32),
                   (B, 2, 1, 1))
    return {
        "context": rng.integers(0, 256, (B, 2, S, S, 3)).astype(np.uint8),
        "context_extent": ext,
        "context_origin": rng.uniform(0, 800, (B, 2, 2)).astype(np.float32),
        "context_scale": np.full((B, 2), context_scale, np.float32),
        "person_box": np.concatenate([lo, hi], -1),
        "intr": intr,
        "gt_j2d": rng.uniform(0, 1500, (B, 2, 22, 2)).astype(np.float32),
        "gt_j2d_conf": rng.uniform(0, 1500, (B, 2, 25, 3)).astype(np.float32),
        "gt_betas": rng.normal(size=(B, 10)).astype(np.float32),
    }


@pytest.mark.parametrize("context_scale", [1.0, 2.0])
def test_finish_batch_matches_jax(context_scale):
    hb = host_batch(context_scale=context_scale)
    want = jp.finish_batch(hb, jax.random.PRNGKey(0), deterministic=True, out_size=64)
    got = tp.finish_batch(hb, None, deterministic=True, out_size=64, device="cpu")
    assert_same_batch({k: v for k, v in got.items() if k != "images"},
                      {k: v for k, v in want.items() if k != "images"}, atol=0, rtol=1e-6)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]),
                               atol=1e-5, rtol=0)
    # the random jitter keeps every key and shape and moves the boxes
    rnd = tp.finish_batch(hb, torch.Generator().manual_seed(0), out_size=64, device="cpu")
    assert {k: v.shape for k, v in rnd.items()} == {k: v.shape for k, v in got.items()}
    assert not torch.equal(rnd["bb"], got["bb"])


def test_finish_batch_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.finish_batch(host_batch())
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.Prefetcher(iter([]))


# ---- Prefetcher (tests/test_data.py's six prefetcher tests) ----

def test_prefetcher_orders_and_terminates():
    batches = [{"x": np.full((2,), i)} for i in range(5)]
    out = list(tp.Prefetcher(iter(batches), device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert torch.is_tensor(b["x"]) and int(b["x"][0]) == i


def test_prefetcher_factory_mode_parallel_workers():
    seen_workers = set()
    lock = threading.Lock()

    def make_batch(wid):
        with lock:
            seen_workers.add(wid)
        time.sleep(0.01)
        return {"wid": np.asarray([wid], np.int32), "tag": np.asarray([wid])}

    pf = tp.Prefetcher.from_factory(make_batch, num_workers=3, device="cpu",
                                    host_keys=("tag",))
    got = [next(pf) for _ in range(12)]
    pf.close()
    assert {int(b["wid"][0]) for b in got} <= {0, 1, 2}
    assert all(isinstance(b["tag"], np.ndarray) and torch.is_tensor(b["wid"]) for b in got)
    assert len(seen_workers) == 3


def test_prefetcher_factory_propagates_errors():
    def bad(wid):
        raise ValueError("boom")

    pf = tp.Prefetcher.from_factory(bad, num_workers=2, device="cpu")
    with pytest.raises(RuntimeError):
        next(pf)


def test_prefetcher_propagates_worker_errors():
    def bad():
        yield {"x": np.ones(2)}
        raise ValueError("corrupt sample")

    it = tp.Prefetcher(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="Prefetcher worker failed"):
        next(it)


def test_prefetcher_error_surfaces_while_siblings_alive():
    def make_batch(wid):
        if wid == 0:
            raise ValueError("corrupt sample")
        time.sleep(0.01)
        return {"x": np.ones(2)}

    it = tp.Prefetcher.from_factory(make_batch, num_workers=3, depth=4, device="cpu")
    with pytest.raises(RuntimeError, match="Prefetcher worker failed"):
        for _ in range(200):
            next(it)


def test_prefetcher_siblings_exit_after_error_and_close():
    def make_batch(wid):
        if wid == 0:
            time.sleep(0.05)
            raise ValueError("corrupt sample")
        return {"x": np.ones(2)}  # floods the bounded queue immediately

    it = tp.Prefetcher.from_factory(make_batch, num_workers=3, depth=3, device="cpu")
    with pytest.raises(RuntimeError, match="Prefetcher worker failed"):
        deadline = time.time() + 20
        while time.time() < deadline:
            next(it)
    for t in it._threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in it._threads)

    healthy = tp.Prefetcher.from_factory(lambda wid: {"x": np.ones(2)}, num_workers=2,
                                         depth=2, device="cpu")
    next(healthy)
    healthy.close()
    for t in healthy._threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in healthy._threads)


# ---- the readers ----

@pytest.fixture(scope="module")
def aerial(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aerial"))
    jparams = jsynthetic_smplx_params(num_vertices=99, seed=4)
    _write_fake_aerialpeople(root, jparams, n=5)
    return root, jparams, port_smplx(jparams)


@pytest.mark.parametrize("swap_cams", [False, True])
def test_aerialpeople_host_batch_matches_jax(aerial, swap_cams):
    root, jparams, tparams = aerial
    jds, tds = jap.AerialPeopleDataset(root, "train"), tap.AerialPeopleDataset(root, "train")
    for gt_cached in (False, True):
        if gt_cached:
            jds.precompute_canonical_gt(jparams)
            tds.precompute_canonical_gt(tparams)
        want = jds.host_batch([0, 3, 1, 4], np.random.default_rng(7), swap_cams=swap_cams)
        got = tds.host_batch([0, 3, 1, 4], np.random.default_rng(7), swap_cams=swap_cams)
        assert ("gt_vertices" in got) == gt_cached
        assert got["context"].sum() > 0
        assert_same_batch(got, want, atol=1e-5, rtol=1e-5)
    # without decoding (no OpenCV needed) the windows stay empty, the rest equal
    nodec = tds.host_batch([0, 3, 1, 4], np.random.default_rng(7), swap_cams=swap_cams,
                           decode_images=False)
    assert nodec["context"].sum() == 0
    assert_same_batch({k: v for k, v in nodec.items() if not k.startswith("context")},
                      {k: v for k, v in got.items() if not k.startswith("context")},
                      atol=0, rtol=0)


def test_aerialpeople_canonical_gt_matches_jax(aerial):
    root, jparams, tparams = aerial
    want = jap.AerialPeopleDataset(root, "test").precompute_canonical_gt(jparams, batch=2)
    got = tap.AerialPeopleDataset(root, "test").precompute_canonical_gt(tparams, batch=2)
    for k in ("pose_aa", "betas", "vertices", "joints"):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale, rtol=0, err_msg=k)
    ds = tap.AerialPeopleDataset(root, "test")
    with pytest.raises(RuntimeError, match="precompute_canonical_gt"):
        ds.canonical_gt([0])


def test_h36m_host_batch_matches_jax(tmp_path):
    _write_fake_h36m(str(tmp_path), n=3)
    for split in ("train", "test"):
        jds = jh36m.H36MDataset(str(tmp_path), split, context_size=256)
        tds = th36m.H36MDataset(str(tmp_path), split, context_size=256)
        for swap in (False, True):
            want = jds.host_batch([0, 2, 1], np.random.default_rng(3), swap_cams=swap)
            got = tds.host_batch([0, 2, 1], np.random.default_rng(3), swap_cams=swap)
            assert_same_batch(got, want, atol=0, rtol=0)
    assert th36m.H36M_MOVABLE == jh36m.H36M_MOVABLE


@pytest.fixture(scope="module")
def totalcap(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("totalcap"))
    _write_fake_totalcap(root, n=5)
    jparams = jsynthetic_smplx_params(num_vertices=99, seed=3)
    return root, jparams, port_smplx(jparams)


def test_totalcap_host_batch_and_gt_match_jax(totalcap):
    root, jparams, tparams = totalcap
    jds = jtc.TotalCaptureDataset(root, view_pair=(1, 5), context_size=128)
    tds = ttc.TotalCaptureDataset(root, view_pair=(1, 5), context_size=128)
    want = jds.host_batch([0, 4, 2], np.random.default_rng(5), swap_cams=True)
    got = tds.host_batch([0, 4, 2], np.random.default_rng(5), swap_cams=True)
    assert_same_batch(got, want, atol=0, rtol=0)

    # the canonical GT, cached (a subset, as an eval over a split makes it)
    # and computed per batch
    jds.precompute_canonical_gt(jparams, chunk=2, indices=[4, 2, 0])
    tds.precompute_canonical_gt(tparams, chunk=2, indices=[4, 2, 0])
    assert tds._canon_rows == jds._canon_rows
    for k in ("orient_w", "body", "vertices", "joints"):
        scale = np.abs(jds._canon_cache[k]).max()
        np.testing.assert_allclose(tds._canon_cache[k], jds._canon_cache[k],
                                   atol=1e-5 * scale, rtol=0, err_msg=k)
    for ds_args in ({"ds": None, "indices": None}, {"ds": "cache", "indices": [0, 4, 2]}):
        jkw = {"ds": jds if ds_args["ds"] else None, "indices": ds_args["indices"]}
        tkw = {"ds": tds if ds_args["ds"] else None, "indices": ds_args["indices"]}
        w = jtc.twoview_gt_from_smpl(want, jparams, **jkw)
        g = ttc.twoview_gt_from_smpl(got, tparams, **tkw)
        assert set(g) == set(w)
        for k in w:
            scale = max(np.abs(np.asarray(w[k])).max(), 1e-6)
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       atol=1e-5 * scale, rtol=0, err_msg=k)


def test_mixed_matches_jax(totalcap, tmp_path):
    root = totalcap[0]
    _write_fake_h36m(str(tmp_path), n=3)
    jm = jmixed.MixedDataset(jh36m.H36MDataset(str(tmp_path), "train", context_size=64),
                             jtc.TotalCaptureDataset(root, context_size=64), p_a=0.5)
    tm = tmixed.MixedDataset(th36m.H36MDataset(str(tmp_path), "train", context_size=64),
                             ttc.TotalCaptureDataset(root, context_size=64), p_a=0.5)
    assert len(tm) == len(jm) == 5
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    seen = set()
    for _ in range(8):
        want = jm.host_batch([0, 6], jr, decode_images=False)
        got = tm.host_batch([0, 6], tr, decode_images=False)
        assert_same_batch(got, want, atol=0, rtol=0)
        seen.add(int(got["mixed_source"][0]))
    assert seen == {0, 1}
    r = np.random.default_rng(9)
    draws = [tmixed.mixed_draw(r, 0.3) for _ in range(50)]
    r = np.random.default_rng(9)
    assert draws == [jmixed.mixed_draw(r, 0.3) for _ in range(50)]


def _diagnosis(make):
    """The DbSchemaError text ``make`` raises (None if it raises none)."""
    try:
        make()
    except (DbSchemaError, JDbSchemaError) as e:
        return str(e)
    return None


def test_schema_diagnoses_match_jax(tmp_path, aerial):
    """The loud first-contact checks give the JAX package's messages word
    for word: a unit drift in an h36m db, a stale frame path, a totalcap
    camera missing, and a broken AerialPeople sample."""
    h = tmp_path / "h36m"
    _write_fake_h36m(str(h), n=2)
    dbp = h / "dsets" / "h36m_db.pkl"
    good = pickle.loads(dbp.read_bytes())
    cases = []
    bad = [dict(r) for r in good]
    bad[0]["gt"] = np.asarray(bad[0]["gt"], np.float64) / 1000.0
    cases.append(("h36m metres", dbp, pickle.dumps(bad), str(h), "h36m"))
    gone = [dict(r) for r in good]
    gone[0]["c1"] = "/nowhere/at/all.jpg"
    cases.append(("h36m stale path", dbp, pickle.dumps(gone), str(h), "h36m"))
    for what, path, blob, root, kind in cases:
        path.write_bytes(blob)
        want = _diagnosis(lambda: jh36m.H36MDataset(root))
        got = _diagnosis(lambda: th36m.H36MDataset(root))
        assert want is not None and got == want, what
    dbp.write_bytes(pickle.dumps(good))

    troot = tmp_path / "tc"
    _write_fake_totalcap(str(troot), n=2)
    want = _diagnosis(lambda: jtc.TotalCaptureDataset(str(troot), view_pair=(1, 9)))
    got = _diagnosis(lambda: ttc.TotalCaptureDataset(str(troot), view_pair=(1, 9)))
    assert want is not None and "'im9'" in want and got == want

    root = aerial[0]
    sp0 = os.path.join(root, "pkls", sorted(os.listdir(os.path.join(root, "pkls")))[0])
    with open(sp0, "rb") as f:
        rec = pickle.load(f)
    try:
        bad = dict(rec)
        bad["smplpose"] = np.degrees(np.asarray(rec["smplpose"]))
        with open(sp0, "wb") as f:
            pickle.dump(bad, f)
        want = _diagnosis(lambda: jap.AerialPeopleDataset(root, "train"))
        got = _diagnosis(lambda: tap.AerialPeopleDataset(root, "train"))
        assert want is not None and "RADIANS" in want and got == want
    finally:
        with open(sp0, "wb") as f:
            pickle.dump(rec, f)
    assert issubclass(DbSchemaError, ValueError)


# ---- tables, vertex mask, render ----

def test_joint_tables_equal_jax():
    names = [n for n in dir(jjoints) if n.isupper()]
    assert names and all(getattr(tjoints, n) == getattr(jjoints, n) for n in names)


def test_body_vertex_mask_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    with open(tmp_path / jvertex_ids.MANO_IDS_FILE, "wb") as f:
        pickle.dump({"left_hand": rng.integers(0, 500, 40),
                     "right_hand": rng.integers(0, 500, 40)}, f)
    np.save(tmp_path / jvertex_ids.FLAME_IDS_FILE, rng.integers(0, 500, 60))
    want = jvertex_ids.load_body_vertex_mask(str(tmp_path), 500)
    got = tvertex_ids.load_body_vertex_mask(str(tmp_path), 500)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="out of range"):
        tvertex_ids.load_body_vertex_mask(str(tmp_path), 100)
    with pytest.raises(FileNotFoundError):
        tvertex_ids.load_body_vertex_mask(str(tmp_path / "none"), 500)


def test_overlay_mesh_matches_jax():
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(60, 3)) * 0.3 + np.asarray([0, 0, 4.0])
    faces = np.stack([np.arange(58), np.arange(1, 59), np.arange(2, 60)], 1)
    img = rng.random((64, 64, 3))
    want = jrender.overlay_mesh(img, verts, faces, (80.0, 80.0))
    got = trender.overlay_mesh(img, verts, faces, (80.0, 80.0))
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    np.testing.assert_array_equal(trender.draw_keypoints(img, [[10, 12]]),
                                  jrender.draw_keypoints(img, [[10, 12]]))
