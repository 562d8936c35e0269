"""The port's tools (airpose_tpu_torch/tools/) and profiling utilities against
the JAX package's, on the CPU, from the same seeds:

- the fixture writers (synth_real_capture, synth_mocap_dbs of both kinds,
  calibration) write the same files: pkls and JSON equal by content, ymls
  byte for byte, JPEGs and PNGs equal pixel for pixel;
- create_aerialpeople: the SMPL-X fields at atol 2e-5
  (tests/test_torch_lbs.py:129-130); the rotations each package builds with
  its own batch_rodrigues (the subject's orientation, the cameras'
  extrinsics) to two f32 ulps at 1 (atol 2.4e-7): torch's and XLA's f32
  sin, cos and sqrt round differently (tests/test_torch_real.py), so each
  quaternion component may lie one ulp apart, and each matrix entry sums
  two to four products of them; measured 1.79e-7 (1.5 ulps at 1) on both
  tools' rotations. Every other field and every image equal. The
  boxes are floors of projected f32 joints and the blobs truncations of
  them, so a projection that lies closer to an integer than the two
  packages' projections lie to each other may round to the neighbouring
  pixel: such a sample is named, its box held to one pixel and its image
  left out of the comparison; the others are held exactly;
- to_hdf5: every field equal, ``--real``'s rotations to two f32 ulps at 1;
- ports of tests/test_tools.py's fast tests against the port's copies;
- qat_posture's ptq arm on weights and data carried from JAX against JAX's
  recipe (qat_posture.py:107-127) at tests/test_torch_int8.py's chain
  bound, and the CLI's five arms;
- train_roofline's stages, and ``--remat`` leaving BatchNorm's running
  statistics (and the gradients) equal to a run without it;
- utils/profiling.
"""

import json
import os
import pickle

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.tools import calibration as jcal
from airpose_tpu.tools import create_aerialpeople as jcreate
from airpose_tpu.tools import synth_mocap_dbs as jmocap
from airpose_tpu.tools import synth_real_capture as jreal
from airpose_tpu.tools import to_hdf5 as jh5
from airpose_tpu_torch.tools import calibration as tcal
from airpose_tpu_torch.tools import create_aerialpeople as tcreate
from airpose_tpu_torch.tools import synth_mocap_dbs as tmocap
from airpose_tpu_torch.tools import synth_real_capture as treal
from airpose_tpu_torch.tools import to_hdf5 as th5

ROT_ATOL = 2.4e-7  # two f32 ulps at 1 (module docstring)
SMPLX_ATOL = 2e-5  # tests/test_torch_lbs.py:129-130


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cv2_one_thread():
    """OpenCV's calibration sums in threads, in an order that changes from
    call to call (measured 6.5e-7 px apart on K): one thread makes two
    calls on the same input agree bit for bit."""
    import cv2

    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


def _assert_same_tree(got, want, path=""):
    """Nested dicts/lists of arrays and scalars equal entry for entry, with
    the same types and dtypes."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def _assert_same_dirs(got_root, want_root):
    """Every file under ``want_root`` has its twin under ``got_root``: pkls
    by content, JSON by value, JPEGs and PNGs by pixels, the rest byte for
    byte (ymls among them)."""
    import cv2

    want_files = sorted(os.path.relpath(os.path.join(d, f), want_root)
                        for d, _, fs in os.walk(want_root) for f in fs)
    got_files = sorted(os.path.relpath(os.path.join(d, f), got_root)
                       for d, _, fs in os.walk(got_root) for f in fs)
    assert got_files == want_files
    for rel in want_files:
        a, b = os.path.join(got_root, rel), os.path.join(want_root, rel)
        if rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                _assert_same_tree(pickle.load(fa), pickle.load(fb), rel)
        elif rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith((".jpg", ".png")):
            ia, ib = cv2.imread(a, cv2.IMREAD_UNCHANGED), cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert ia.shape == ib.shape, rel
            np.testing.assert_array_equal(ia, ib, err_msg=rel)
        elif rel.endswith(".h5"):
            _assert_same_h5(a, b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    return want_files


def _h5_items(path):
    out = {}
    with h5py.File(path) as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[...]
            out.update({f"{name}@{k}": v for k, v in obj.attrs.items()})
        f.visititems(visit)
    return out


def _assert_same_h5(got, want, rot_keys=()):
    g, w = _h5_items(got), _h5_items(want)
    assert g.keys() == w.keys()
    for k in w:
        if any(r in k for r in rot_keys):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=ROT_ATOL, err_msg=k)
        elif isinstance(w[k], np.ndarray):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g[k] == w[k], k


# ---- the fixture writers ---------------------------------------------------------

def test_synth_real_capture_matches_jax(tmp_path):
    jreal.main(["--out", str(tmp_path / "j"), "--frames", "5", "--seed", "3"])
    treal.main(["--out", str(tmp_path / "t"), "--frames", "5", "--seed", "3"])
    files = _assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(files) == 2 * (5 + 4)


@pytest.mark.parametrize("kind", ["h36m", "totalcap"])
def test_synth_mocap_dbs_match_jax(tmp_path, kind):
    if kind == "h36m":
        jmocap.write_h36m(str(tmp_path / "j"), n=2, img_size=96)
        tmocap.write_h36m(str(tmp_path / "t"), n=2, img_size=96)
    else:
        jmocap.write_totalcap(str(tmp_path / "j"), n=2, frame_wh=(64, 48))
        tmocap.write_totalcap(str(tmp_path / "t"), n=2, frame_wh=(64, 48))
    files = _assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(files) == (2 * 4 + 2 if kind == "h36m" else 2 * 8 + 2)


def test_synth_mocap_dbs_cli_matches_jax(tmp_path):
    jmocap.main(["--kind", "totalcap", "--out", str(tmp_path / "j"), "-n", "1"])
    tmocap.main(["--kind", "totalcap", "--out", str(tmp_path / "t"), "-n", "1"])
    _assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))


def test_calibration_matches_jax(tmp_path, rng, cv2_one_thread):
    """Marker images, the yml writer, ArUco detection and poses, the
    markerposes pkl, calibration from points and from chessboard frames:
    the same OpenCV calls on the same inputs give the same outputs."""
    import cv2

    for mid, size in ((0, 200), (7, 120)):
        np.testing.assert_array_equal(tcal.generate_aruco_marker(mid, size),
                                      jcal.generate_aruco_marker(mid, size))
    K = np.asarray([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    for pkg, name in ((jcal, "j"), (tcal, "t")):
        os.makedirs(tmp_path / name)
        pkg.save_calib_yml(str(tmp_path / name / "camera_calib.yml"), K, np.zeros((1, 5)))
    frames = {}
    for k in range(3):
        frame = np.full((480, 640), 255, np.uint8)
        frame[140:340, 200 + 15 * k:400 + 15 * k] = jcal.generate_aruco_marker(0, 200)
        frames[f"{k:06d}"] = frame
    for pkg, name in ((jcal, "j"), (tcal, "t")):
        pkg.build_markerposes_pkl(frames, K, np.zeros(5),
                                  str(tmp_path / name / "markerposes_corrected_all.pkl"), 0.5)
    _assert_same_dirs(str(tmp_path / "t"), str(tmp_path / "j"))
    with open(tmp_path / "t" / "markerposes_corrected_all.pkl", "rb") as f:
        assert all("0" in v for v in pickle.load(f).values())

    board = np.zeros((6 * 9, 3), np.float32)
    board[:, :2] = np.mgrid[0:9, 0:6].T.reshape(-1, 2) * 0.05
    obj, img = [], []
    for k in range(5):
        uv, _ = cv2.projectPoints(board, rng.normal(0, 0.3, 3),
                                  np.asarray([0.0, 0.0, 1.5 + 0.2 * k]), K, np.zeros(5))
        obj.append(board)
        img.append(uv.reshape(-1, 2))
    got, want = tcal.calibrate_from_points(obj, img, (640, 480)), \
        jcal.calibrate_from_points(obj, img, (640, 480))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    calib_dir = _write_chessboard_calib_frames(tmp_path, K, 0.05)
    frames = [cv2.imread(str(calib_dir / n)) for n in sorted(os.listdir(calib_dir))]
    for g, w in zip(tcal.calibrate_chessboard(frames, square_size=0.05),
                    jcal.calibrate_chessboard(frames, square_size=0.05)):
        np.testing.assert_array_equal(g, w)


# ---- create_aerialpeople ---------------------------------------------------------

def _floor_args(sample, cam):
    """What the tool floors (the box corners before the floor) and truncates
    (the blob centres) in ``cam``, from the sample's stored joints and
    camera (create_aerialpeople.py:110-145)."""
    import airpose_tpu_torch.constants as C

    K = sample[f"cam{cam}"]["intr"]
    R, t = sample[f"cam{cam}"]["extr"][:, :3], sample[f"cam{cam}"]["extr"][:, 3]
    j = sample["smpl_joints_wrt_origin"][0, :24] @ R.T + t
    uv = j[:, :2] / j[:, 2:] * np.asarray(C.FOCAL_LENGTH) + K[:2, 2]
    return np.concatenate([uv.min(0) - 20, uv.max(0) + 20, uv.ravel()])


def test_create_aerialpeople_matches_jax(tmp_path):
    args = ["--subjects", "3", "--poses-per-subject", "2", "--num-vertices", "120",
            "--render-blobs", "--seed", "1"]
    jcreate.main(["--out", str(tmp_path / "j"), *args])
    tcreate.main(["--out", str(tmp_path / "t"), *args, "--platform", "cpu"])
    for split in ("train", "test"):
        with open(tmp_path / "j" / "dataset" / f"{split}_pkls.pkl", "rb") as f:
            want = [os.path.relpath(p, tmp_path / "j") for p in pickle.load(f)]
        with open(tmp_path / "t" / "dataset" / f"{split}_pkls.pkl", "rb") as f:
            assert [os.path.relpath(p, tmp_path / "t") for p in pickle.load(f)] == want

    import cv2

    names = sorted(os.listdir(tmp_path / "j" / "pkls"))
    assert names == sorted(os.listdir(tmp_path / "t" / "pkls")) and len(names) == 6
    ambiguous, compared = [], 0
    for name in names:
        with open(tmp_path / "j" / "pkls" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "t" / "pkls" / name, "rb") as f:
            got = pickle.load(f)
        assert got.keys() == want.keys()
        for k in ("smpl_vertices_wrt_origin", "smpl_joints_wrt_origin"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SMPLX_ATOL, err_msg=k)
        np.testing.assert_allclose(got["smplorient_rotmat_wrt_origin"],
                                   want["smplorient_rotmat_wrt_origin"], rtol=0, atol=ROT_ATOL)
        for k in ("smplpose", "smplshape", "smplgender", "smpltrans", "im0", "im1"):
            _assert_same_tree(got[k], want[k], k)
        for cam in (0, 1):
            c, cw = got[f"cam{cam}"], want[f"cam{cam}"]
            np.testing.assert_array_equal(c["intr"], cw["intr"])
            np.testing.assert_allclose(c["extr"], cw["extr"], rtol=0, atol=ROT_ATOL)
            np.testing.assert_array_equal(c["extr"][:, 3], cw["extr"][:, 3])
            # a value this close to an integer may floor either way
            a, b = _floor_args(got, cam), _floor_args(want, cam)
            margin = np.abs(b - np.round(b))
            img_t = cv2.imread(str(tmp_path / "t" / got[f"im{cam}"]))
            img_j = cv2.imread(str(tmp_path / "j" / want[f"im{cam}"]))
            if (margin <= np.abs(a - b) + 1e-9).any():
                ambiguous.append(f"{name} cam{cam}")
                assert np.abs(got[f"bb{cam}"] - want[f"bb{cam}"]).max() <= 1.0
                continue
            np.testing.assert_array_equal(got[f"bb{cam}"], want[f"bb{cam}"])
            assert img_t.shape == img_j.shape
            np.testing.assert_array_equal(img_t, img_j, err_msg=f"{name} cam{cam}")
            compared += 1
    print(f"ambiguous floors: {ambiguous or 'none'}; {compared} images compared")
    assert compared >= 10, ambiguous


def test_create_aerialpeople_tool_roundtrip(tmp_path, rng):
    """tests/test_tools.py's round trip through the port's reader."""
    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.data import AerialPeopleDataset

    out = str(tmp_path / "ds")
    tcreate.main(["--out", out, "--subjects", "3", "--poses-per-subject", "2",
                  "--num-vertices", "120", "--render-blobs", "--platform", "cpu"])
    ds_train = AerialPeopleDataset(out, "train")
    ds_test = AerialPeopleDataset(out, "test")
    assert len(ds_train) == 4 and len(ds_test) == 2

    params = synthetic_smplx_params(num_vertices=120, seed=0)
    cache = ds_train.precompute_canonical_gt(params)
    assert cache["vertices"].shape == (4, 120, 3)
    hb = ds_train.host_batch([0, 1], rng, swap_cams=False)
    assert hb["context"].shape[0] == 2
    assert np.isfinite(hb["gt_j2d"]).all()


# ---- to_hdf5 ---------------------------------------------------------------------

def test_hdf5_export(tmp_path):
    """tests/test_tools.py's export, and the file equal to JAX's."""
    out = str(tmp_path / "ds")
    tcreate.main(["--out", out, "--subjects", "2", "--poses-per-subject", "1",
                  "--num-vertices", "60", "--platform", "cpu"])
    h5path = str(tmp_path / "train.h5")
    assert th5.export_split(out, "train", h5path) == 1
    with h5py.File(h5path) as f:
        g = f["000000"]
        assert g["smplpose"].shape == (63,)
        assert g["cam0"]["intr"].shape == (3, 3)
        assert g.attrs["smplgender"] in ("male", "female", "neutral")
    jh5.export_split(out, "train", str(tmp_path / "train_jax.h5"))
    _assert_same_h5(h5path, str(tmp_path / "train_jax.h5"))


def _fake_outputs(tmp_path):
    rng = np.random.default_rng(0)

    def fake_split(n):
        return [{"output": {
            f"pred_angles{v}": rng.normal(size=(n, 22, 3)).astype(np.float32)
            for v in (0, 1)
        } | {
            f"pred_smpltrans{v}": rng.normal(size=(n, 3)).astype(np.float32)
            for v in (0, 1)
        }}]

    per_split = [fake_split(2), fake_split(4)]  # [test, train]
    res_pkl = str(tmp_path / "res.pkl")
    with open(res_pkl, "wb") as f:
        pickle.dump(per_split, f)
    return per_split, res_pkl


def test_hdf5_real_export(tmp_path):
    """tests/test_tools.py's --real export through the port (its rotations
    from the port's batch_rodrigues), and each file against JAX's: every
    field equal, the rotations to two f32 ulps at 1."""
    from airpose_tpu_torch.geometry.rotations import batch_rodrigues

    cap = str(tmp_path / "capture")
    treal.write_capture(cap, n_frames=6, seed=2)
    per_split, res_pkl = _fake_outputs(tmp_path)
    argv = ["--real", "--datapath", cap, "--outputs_pkl", res_pkl,
            "--splits", "test", "train", "--train_frames", "0", "4", "--test_frames", "4", "6"]
    h5path = str(tmp_path / "real.h5")
    th5.main(argv + ["--out", h5path, "--platform", "cpu"])
    with h5py.File(h5path) as f:
        assert f["joints2d_train_gt0"].shape == (4, 2, 24, 3)
        assert f["joints2d_test_gt1"].shape == (2, 2, 24, 3)
        T = f["smpl_wrt_cam1_train"][...]
        assert T.shape == (4, 4, 4)
        np.testing.assert_array_equal(T[:, 3], [[0, 0, 0, 1]] * 4)
        want_rot = batch_rodrigues(torch.from_numpy(
            per_split[1][0]["output"]["pred_angles1"][:, 0])).numpy()
        np.testing.assert_array_equal(T[:, :3, :3], want_rot)
        np.testing.assert_array_equal(T[:, :3, 3],
                                      per_split[1][0]["output"]["pred_smpltrans1"])
        paths = [p.decode() for p in f["im0_test"][...]]
        assert paths[0].endswith("machine_1/images/000004.jpg")
    jh5.main(argv + ["--out", str(tmp_path / "real_jax.h5")])
    _assert_same_h5(h5path, str(tmp_path / "real_jax.h5"), rot_keys=("smpl_wrt_cam",))

    # --splits must match the pkl's split count (the compile run's --split)
    with pytest.raises(SystemExit):
        th5.main(["--real", "--datapath", cap, "--outputs_pkl", res_pkl,
                  "--out", str(tmp_path / "bad.h5"), "--train_frames", "0", "4",
                  "--test_frames", "4", "6", "--platform", "cpu"])

    # --first_cam 1: prediction view 0 saw machine_2
    flip = argv + ["--first_cam", "1"]
    th5.main(flip + ["--out", str(tmp_path / "flip.h5"), "--platform", "cpu"])
    jh5.main(flip + ["--out", str(tmp_path / "flip_jax.h5")])
    _assert_same_h5(str(tmp_path / "flip.h5"), str(tmp_path / "flip_jax.h5"),
                    rot_keys=("smpl_wrt_cam",))
    with h5py.File(tmp_path / "flip.h5") as f:
        np.testing.assert_array_equal(f["smpl_wrt_cam1_train"][:, :3, 3],
                                      per_split[1][0]["output"]["pred_smpltrans0"])


# ---- ArUco and calibration (tests/test_tools.py's fast tests) -------------------

def test_aruco_generate_detect_pose():
    marker = tcal.generate_aruco_marker(0, 200)
    frame = np.full((480, 640), 255, np.uint8)
    frame[140:340, 220:420] = marker
    K = np.asarray([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    poses = tcal.detect_aruco_poses(frame, K, np.zeros(5), marker_length=0.5)
    assert "0" in poses, poses
    tvec = poses["0"]["tvec"]
    assert tvec[2] > 0
    assert abs(tvec[0]) < 0.2 * tvec[2] and abs(tvec[1]) < 0.2 * tvec[2]


def _write_chessboard_calib_frames(tmp_path, K_true, square_m=0.05, n=6):
    """Warped-chessboard calib frames: 10x7 squares = 9x6 inner corners,
    40px squares, white border so warped edges don't fake corners."""
    import cv2

    sq = 40
    tex = np.full(((7 + 2) * sq, (10 + 2) * sq), 255, np.uint8)
    for r in range(7):
        for c in range(10):
            if (r + c) % 2 == 0:
                tex[(r + 1) * sq:(r + 2) * sq, (c + 1) * sq:(c + 2) * sq] = 0
    calib_dir = tmp_path / "calib_frames"
    os.makedirs(calib_dir, exist_ok=True)
    for k in range(n):
        rvec = np.asarray([0.25 * np.sin(k), 0.25 * np.cos(1.3 * k), 0.1 * k])
        tvec = np.asarray([-0.25 + 0.02 * k, -0.18, 1.2 + 0.1 * k])
        plane = np.asarray([[0, 0, 0], [10 * square_m, 0, 0],
                            [10 * square_m, 7 * square_m, 0], [0, 7 * square_m, 0]],
                           np.float32)
        uv, _ = cv2.projectPoints(plane, rvec, tvec, K_true, np.zeros(5))
        src = np.asarray([[sq, sq], [11 * sq, sq], [11 * sq, 8 * sq], [sq, 8 * sq]],
                         np.float32)
        H, _ = cv2.findHomography(src, uv.reshape(-1, 2))
        frame = cv2.warpPerspective(tex, H, (640, 480), borderValue=255)
        cv2.imwrite(str(calib_dir / f"{k:03d}.png"), frame)
    return calib_dir


def _write_aruco_capture_frames(tmp_path, n=4):
    import cv2

    capture_dir = tmp_path / "capture_frames"
    os.makedirs(capture_dir, exist_ok=True)
    marker = tcal.generate_aruco_marker(0, 200)
    for k in range(n):
        frame = np.full((480, 640), 255, np.uint8)
        x = 200 + 10 * k
        frame[140:340, x:x + 200] = marker
        cv2.imwrite(str(capture_dir / f"{k:03d}.jpg"), frame)
    return capture_dir


def test_prepare_real_capture_cli(tmp_path, cv2_one_thread):
    """The per-machine preparation CLI end to end (tests/test_tools.py), and
    the machine directory equal to the JAX CLI's."""
    from airpose_tpu.tools.prepare_real_capture import main as jmain
    from airpose_tpu_torch.data.real import load_calib_yml
    from airpose_tpu_torch.tools.prepare_real_capture import main

    K_true = np.asarray([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]])
    calib_dir = _write_chessboard_calib_frames(tmp_path, K_true, 0.05)
    capture_dir = _write_aruco_capture_frames(tmp_path)
    argv = ["--calib", str(calib_dir), "--capture", str(capture_dir), "--calib_stride", "1",
            "--square_size", "0.05", "--marker_length", "0.5", "--plot-markers"]
    machine = str(tmp_path / "machine_1")
    main(["--machine_dir", machine, *argv])
    assert os.path.exists(os.path.join(machine, "markerposes.png"))
    K = load_calib_yml(os.path.join(machine, "camera_calib.yml"))
    np.testing.assert_allclose(K[0, 0], 600.0, rtol=0.15)
    assert sorted(os.listdir(os.path.join(machine, "images"))) == [
        f"{i:06d}.jpg" for i in range(4)]
    with open(os.path.join(machine, "markerposes_corrected_all.pkl"), "rb") as f:
        poses = pickle.load(f)
    assert len(poses) == 4 and "0" in next(iter(poses.values()))

    jmain(["--machine_dir", str(tmp_path / "jax" / "machine_1"), *argv])
    os.remove(os.path.join(machine, "markerposes.png"))  # matplotlib's bytes: not ours
    os.remove(tmp_path / "jax" / "machine_1" / "markerposes.png")
    _assert_same_dirs(machine, str(tmp_path / "jax" / "machine_1"))


def test_prepare_real_capture_plot_needs_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib (the card machine) --plot-markers is left out with
    a printed reason; the rest of the preparation runs."""
    import importlib.util

    from airpose_tpu_torch.tools.prepare_real_capture import main

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    machine = str(tmp_path / "machine_1")
    tcal.save_calib_yml(os.path.join(os.makedirs(machine) or machine, "camera_calib.yml"),
                        np.asarray([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]]),
                        np.zeros((1, 5)))
    main(["--machine_dir", machine, "--capture", str(_write_aruco_capture_frames(tmp_path)),
          "--marker_length", "0.5", "--plot-markers"])
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(machine, "markerposes.png"))
    assert os.path.exists(os.path.join(machine, "markerposes_corrected_all.pkl"))


def test_calibration_from_synthetic_points(rng):
    import cv2

    K_true = np.asarray([[800.0, 0, 320], [0, 820.0, 240], [0, 0, 1]])
    board = np.zeros((6 * 9, 3), np.float32)
    board[:, :2] = np.mgrid[0:9, 0:6].T.reshape(-1, 2) * 0.05
    obj_pts, img_pts = [], []
    for k in range(6):
        rvec = rng.normal(0, 0.3, 3)
        tvec = np.asarray([rng.normal(0, 0.1), rng.normal(0, 0.1), 1.5 + 0.2 * k])
        uv, _ = cv2.projectPoints(board, rvec, tvec, K_true, np.zeros(5))
        obj_pts.append(board)
        img_pts.append(uv.reshape(-1, 2))
    K, dist, rms = tcal.calibrate_from_points(obj_pts, img_pts, (640, 480))
    assert rms < 1.0
    np.testing.assert_allclose(K[0, 0], 800.0, rtol=0.05)
    np.testing.assert_allclose(K[1, 1], 820.0, rtol=0.05)


def test_prepare_real_capture_downsample_scales_K(tmp_path):
    """--downsample N: the saved K describes the downsampled capture and
    the ArUco extrinsics are solved with it, so the marker's distance
    matches between a full-res and a downsample-2 preparation."""
    from airpose_tpu_torch.data.real import load_calib_yml
    from airpose_tpu_torch.tools.prepare_real_capture import main

    K_true = np.asarray([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]])
    calib_dir = _write_chessboard_calib_frames(tmp_path, K_true, 0.05)
    capture_dir = _write_aruco_capture_frames(tmp_path)
    tvecs = {}
    for ds in (1, 2):
        machine = str(tmp_path / f"machine_ds{ds}")
        main(["--machine_dir", machine, "--calib", str(calib_dir), "--capture",
              str(capture_dir), "--calib_stride", "1", "--square_size", "0.05",
              "--marker_length", "0.5", "--downsample", str(ds)])
        K = load_calib_yml(os.path.join(machine, "camera_calib.yml"))
        np.testing.assert_allclose(K[0, 0], 600.0 / ds, rtol=0.15)
        np.testing.assert_allclose(K[0, 2], 320.0 / ds, rtol=0.15)
        with open(os.path.join(machine, "markerposes_corrected_all.pkl"), "rb") as f:
            tvecs[ds] = np.asarray(pickle.load(f)["000000"]["0"]["tvec"]).ravel()
    np.testing.assert_allclose(np.linalg.norm(tvecs[2]), np.linalg.norm(tvecs[1]), rtol=0.1)


# ---- qat_posture -----------------------------------------------------------------

def test_qat_posture_ptq_matches_jax():
    """--steps_pre 0: the ptq arm's deployed loss on the JAX tool's data and
    on weights carried from flax, against JAX's recipe for it
    (qat_posture.py:107-127: the table calibrated on the training batch,
    the weights quantized, twoview_int8_forward, twoview_loss). On carried
    weights the two int8 trunks agree bit for bit and the calibrated
    tables are equal, and the two losses measured equal (a relative gap of
    0.0 on a loss of ~8.5e5); the bound, rel 1e-6, is about 16 f32 ulps of
    that loss, room for the f32 IEF and loss chains only. Every fine-tuned
    arm at 0 steps equals the ptq arm."""
    from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic
    from airpose_tpu.config import TrainConfig as JTrainConfig
    from airpose_tpu.data import batch_slice as jbatch_slice
    from airpose_tpu.data import make_synthetic_dataset as jdataset
    from airpose_tpu.ops import int8_trunk as jq
    from airpose_tpu.train import losses as JL
    from airpose_tpu.train.checkpoint import convert_reference_checkpoint
    from airpose_tpu.models import AirPoseTwoView as JAirPoseTwoView
    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.data import batch_slice
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.tools.qat_posture import run_posture
    from airpose_tpu_torch.train.checkpoint import load_reference_state_dict, state_dict_from_flax

    B, IMG, V = 2, 64, 60
    jsmplx = jsynthetic(num_vertices=V, seed=3)
    data = {k: np.asarray(v) for k, v in
            jdataset(jsmplx, num_samples=B, seed=5, img_size=IMG, blob_sigma=3.0).items()}
    jbatch = jbatch_slice(data, 0, B)
    # flax variables from the port's seed-0 weights (BN statistics moved
    # off (0, 1)), and the same weights in the port
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in AirPoseTwoView(seed=0).state_dict().items():
        if k.endswith("running_mean"):
            v = v + torch.from_numpy(rng.normal(0, 0.05, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            v = v * torch.from_numpy(rng.uniform(0.8, 1.2, v.shape).astype(np.float32))
        sd["model." + (k.split(".", 1)[1] if k.startswith(("trunk.", "core.")) else k)] = v
    variables = convert_reference_checkpoint(sd)

    cfg = JTrainConfig(lr=1e-4, batch_size=B, img_res=IMG)
    imgs = jnp.asarray(jbatch["images"])
    table = jq.calibrate_act_scales(jq.quantize_trunk_params(variables),
                                    imgs.reshape((-1,) + imgs.shape[-3:]))
    t = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 10.0], jnp.float32) * cfg.trans_scale,
                         jbatch["gt_trans"].shape)
    out = jq.twoview_int8_forward(JAirPoseTwoView(iters=cfg.reg_iters), variables,
                                  jq.quantize_trunk_params(variables), table, imgs,
                                  jnp.asarray(jbatch["bb"]), t, iters=cfg.reg_iters)
    want, _ = JL.twoview_loss(out.pose, out.betas, jbatch, jsmplx, cfg.loss, cfg.trans_scale)
    want = float(want)

    model = AirPoseTwoView()
    load_reference_state_dict(model, state_dict_from_flax(variables))
    batch = batch_slice(data, 0, B, "cpu")
    got = run_posture(model, synthetic_smplx_params(num_vertices=V, seed=3), [batch], batch,
                      TrainConfig(lr=1e-4, batch_size=B, img_res=IMG), 0, 0)
    assert set(got) == {"bf16", "ptq", "bf16_ft", "dynamic", "frozen"}
    assert abs(got["ptq"] / want - 1) < 1e-6, (got["ptq"], want)
    assert got["bf16_ft"] == got["dynamic"] == got["frozen"] == got["ptq"]


@pytest.mark.parametrize("argv", [
    ["--steps_pre", "2", "--steps_ft", "2", "--num_batches", "2"],
    ["--steps_pre", "1", "--steps_ft", "1"],
], ids=["held-out", "one-batch"])
def test_qat_posture_cli(argv, capsys):
    """tests/test_tools.py's posture smoke: every arm finite, in both the
    held-out and the overfit-one-batch modes."""
    from airpose_tpu_torch.tools.qat_posture import main

    results = main(["--batch", "2", "--img", "64", "--verts", "60", *argv,
                    "--platform", "cpu"])
    assert "deployed-int8 eval loss [frozen ]" in capsys.readouterr().out
    assert set(results) == {"bf16", "ptq", "bf16_ft", "dynamic", "frozen"}
    for k, v in results.items():
        assert np.isfinite(v), (k, v)


# ---- train_roofline --------------------------------------------------------------

def test_train_roofline_stages(capsys):
    """tests/test_tools.py's roofline smoke on tiny CPU shapes: every stage
    asked for gives a finite positive time, and the trunk-only stage is
    bounded by the whole-model stage."""
    from airpose_tpu_torch.tools.train_roofline import main

    results = main(["--batch", "2", "--img", "32", "--length", "1",
                    "--stages", "full,fwdbwd_model,fwdbwd_trunk,opt", "--platform", "cpu"])
    assert "train roofline" in capsys.readouterr().out
    assert set(results) == {"full", "fwdbwd_model", "fwdbwd_trunk", "opt"}
    for k, v in results.items():
        assert np.isfinite(v) and v > 0, (k, v)
    assert results["fwdbwd_trunk"] < results["full"] * 3


def test_train_roofline_remat_keeps_batchnorm_statistics():
    """A fwd+bwd of the train-mode trunk under --remat moves BatchNorm's
    running statistics once, as without it (the recompute puts back what
    it moved), and gives the same gradients; a train step of the model
    under it, the same statistics and parameters."""
    import copy

    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.config import TrainConfig
    from airpose_tpu_torch.data import batch_slice, make_synthetic_dataset
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.tools.train_roofline import rematerialized
    from airpose_tpu_torch.train import create_train_state, make_twoview_step_fns

    def stats(m):
        return {n: b.clone() for n, b in m.named_buffers() if "running" in n}

    model = AirPoseTwoView(seed=0)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    runs = []
    for remat in (False, True):
        m = copy.deepcopy(model)
        with rematerialized(m.trunk, remat):
            y = m.trunk(x, train=True)
            g = torch.autograd.grad(y.sum(), list(m.trunk.parameters()))
        runs.append((y, g, stats(m)))
    (y0, g0, s0), (y1, g1, s1) = runs
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert any(not torch.equal(s0[k], v) for k, v in stats(model).items())

    smplx = synthetic_smplx_params(num_vertices=60, seed=3)
    batch = batch_slice(make_synthetic_dataset(smplx, 2, img_size=32), 0, 2, "cpu")
    cfg = TrainConfig()  # the same seed draws the same dropout masks in both steps
    after = []
    for remat in (False, True):
        m = copy.deepcopy(model)
        state, tx = create_train_state(m, cfg.lr)
        train_step, _ = make_twoview_step_fns(m, smplx, cfg, tx, device="cpu")
        with rematerialized(m.trunk, remat):
            train_step(state, batch, torch.Generator().manual_seed(1))
        after.append(m.state_dict())
    assert all(torch.equal(after[0][k], after[1][k]) for k in after[0])


# ---- utils/profiling -------------------------------------------------------------

def test_profiling(tmp_path):
    from airpose_tpu_torch.utils.profiling import sync, trace

    out = {"a": [torch.ones(3) * 2], "b": None}
    assert sync(out) == 2.0 and sync({}) == 0.0
    with trace(str(tmp_path / "tr")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert any(e.name == "aten::mm" for e in prof.events())
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_span_is_one_flag_check_without_profiler(monkeypatch):
    """With no profiler recording, every span is the one shared null context
    and enters no record_function; under the profiler each is a
    ``record_function`` that the trace holds by its name."""
    from torch.profiler import ProfilerActivity, profile

    from airpose_tpu_torch.utils import profiling

    entered = []
    real = profiling.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counted)
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        torch.ones(2) + 1
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("a"):
            torch.ones(2) + 1
    assert entered == ["a"]
    assert [e.name for e in prof.events() if e.name == "a"] == ["a"]
