"""The port's face path against the JAX package on the CPU: the blur and
nearest resize, the warps and paste masks of utils/face_restore.py,
RetinaFace and ParseNet (at small canvases and depth), their facexlib
checkpoint converters, and apps/face_demo.py:restore_with_faces on the
tiny engine with injected noise.

Bounds: fp32, atol 2e-3 and rtol 2e-3 unless a test says otherwise; the
blur, warp and masks 1e-5 (the same fp32 arithmetic in another order);
the converters bit for bit; restore_with_faces 5e-5, the bound of the
batch-restore slice (tests/test_torch_cli.py). Weights are random from a
numpy seed, BatchNorm variances kept positive, and cross into the port
through utils/weights.py. JAX is imported inside the helpers, so the
`gpu` tests at the end run where it is not installed.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from supir_tpu_torch.apps.face_demo import restore_with_faces
from supir_tpu_torch.models.parsenet import FaceParser, ParseNet
from supir_tpu_torch.models.retinaface import RetinaFace, RetinaFaceDetector
from supir_tpu_torch.ops import resize as TR
from supir_tpu_torch.utils import face_ckpt as TFC
from supir_tpu_torch.utils import face_restore as TF
from supir_tpu_torch.utils import weights as W
from torch_parity import one_torch_thread  # noqa: F401

ATOL = RTOL = 2e-3
PIXEL_ATOL = 1e-5
SLICE_BOUND = 5e-5
ROOT = Path(__file__).resolve().parents[1]


def face_params(shapes, seed):
    """Random leaves for a face model's flax tree: conv kernels N(0,
    1/fan_in), BatchNorm scales near 1 and variances in [1, ~2]."""
    import jax

    from torch_parity import _random_leaf

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name.endswith("_var"):
            return (1.0 + 0.2 * np.abs(rng.standard_normal(leaf.shape))).astype(np.float32)
        if name.endswith("_scale"):
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return _random_leaf(name, leaf.shape, rng)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _shapes(model, size):
    import jax
    import jax.numpy as jnp

    return jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"]


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("shape,ksize,sigma", [((2, 40, 30, 3), 9, 2.0), ((1, 128, 128, 1), 101, 11.0),
                                               ((1, 64, 64, 1), 25, 3.8)])
def test_gaussian_blur_matches_jax(shape, ksize, sigma):
    import jax.numpy as jnp

    from supir_tpu.ops.resize import gaussian_blur

    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(gaussian_blur(jnp.asarray(x), ksize, sigma))
    got = TR.gaussian_blur(torch.from_numpy(x), ksize, sigma).numpy()
    np.testing.assert_allclose(got, want, atol=PIXEL_ATOL, rtol=0)
    with pytest.raises(ValueError, match="odd"):
        TR.gaussian_blur(torch.from_numpy(x), 4, 1.0)


@pytest.mark.parametrize("m_in,m_out", [(4, 7), (7, 13), (13, 25), (8, 16)])
def test_nearest_resize_matches_jax(m_in, m_out):
    """jax.image's nearest (half-pixel centres) exactly, also at the FPN's
    sizes of a canvas that is no multiple of 32 (100: 4 -> 7 -> 13), where
    F.interpolate's nearest picks other rows."""
    import jax.numpy as jnp

    from supir_tpu.ops.resize import nearest_resize

    y = np.random.default_rng(1).random((1, 2, m_in, m_in + 1)).astype(np.float32)
    size = (m_out, m_out + 2)
    want = np.asarray(nearest_resize(jnp.asarray(y).transpose(0, 2, 3, 1), size)).transpose(0, 3, 1, 2)
    got = TR.nearest_resize(torch.from_numpy(y), size).numpy()
    np.testing.assert_array_equal(got, want)
    if m_out % m_in:
        other = torch.nn.functional.interpolate(torch.from_numpy(y), size=size, mode="nearest").numpy()
        assert not np.array_equal(other, want)


# ------------------------------------------------------------------ warps and masks


@pytest.mark.parametrize("case", ["inside", "outside", "upscale"])
def test_warp_affine_matches_jax(case):
    """Bilinear with the taps' indices clamped: also where the output
    samples points outside the image (the edge pixels repeat)."""
    from supir_tpu.utils.face_restore import warp_affine

    rng = np.random.default_rng(2)
    img = rng.random((50, 70, 3)).astype(np.float32)
    m = {"inside": np.array([[0.8, 0.1, 2.0], [-0.1, 0.7, 3.0]], np.float32),
         "outside": np.array([[1.2, 0.3, -30.0], [-0.2, 1.1, 25.0]], np.float32),
         "upscale": np.array([[2.5, 0.0, -0.3], [0.0, 2.5, 0.7]], np.float32)}[case]
    want = warp_affine(img, m, (60, 80))
    got = TF.warp_affine(torch.from_numpy(img), m, (60, 80)).numpy()
    np.testing.assert_allclose(got, want, atol=PIXEL_ATOL, rtol=0)
    if case == "outside":  # some outputs sample beyond the edge
        minv = TF.invert_affine(m)
        xs = minv[0, 0] * np.arange(80) + minv[0, 2]
        assert (xs < 0).any() or (xs > 69).any()


@pytest.mark.parametrize("size,upscale", [(64, 1), (128, 2), (512, 1)])
def test_soft_erosion_mask_matches_jax(size, upscale):
    from supir_tpu.utils.face_restore import soft_erosion_mask

    want = soft_erosion_mask(size, upscale)
    got = TF.soft_erosion_mask(size, upscale).numpy()
    np.testing.assert_allclose(got, want, atol=PIXEL_ATOL, rtol=0)


def _two_faces(img):
    """A landmark callable: two faces at fixed places of any image."""
    h, w = img.shape[:2]
    base = (TF.FACE_TEMPLATE_512 - 256.0) * (min(h, w) / 1100.0)
    return np.stack([base + np.array([w * 0.3, h * 0.4], np.float32),
                     base * 0.8 + np.array([w * 0.7, h * 0.6], np.float32)])


def test_align_and_paste_match_jax():
    from supir_tpu.utils.face_restore import FaceRestoreHelper

    rng = np.random.default_rng(3)
    img = rng.random((80, 120, 3)).astype(np.float32)
    jhelper = FaceRestoreHelper(face_size=48, detector=_two_faces)
    thelper = TF.FaceRestoreHelper(face_size=48, detector=_two_faces)
    jfaces = jhelper.align_warp_faces(img)
    tfaces = thelper.align_warp_faces(torch.from_numpy(img))
    assert len(tfaces) == len(jfaces) == 2
    for t, j in zip(tfaces, jfaces):
        np.testing.assert_array_equal(t.affine, j.affine)
        np.testing.assert_allclose(t.crop.numpy(), j.crop, atol=PIXEL_ATOL, rtol=0)
    restored = [rng.random((48, 48, 3)).astype(np.float32) for _ in jfaces]
    want = jhelper.paste_faces_to_input_image(img, jfaces, restored)
    got = thelper.paste_faces_to_input_image(torch.from_numpy(img), tfaces, [torch.from_numpy(r) for r in restored])
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL, rtol=0)
    assert np.abs(want - img).max() > 0.1  # the faces were pasted


@pytest.fixture(scope="module")
def parsers():
    """A ParseNet at in_size 64, depth 2, in both packages on one random tree."""
    import jax

    from supir_tpu.models.parsenet import FaceParser as JFaceParser
    from supir_tpu.models.parsenet import ParseNet as JParseNet

    params = face_params(_shapes(JParseNet(in_size=64, res_depth=2), 64), seed=4)
    jparser = JFaceParser(jax.tree_util.tree_map(np.asarray, params), in_size=64, res_depth=2)
    tparser = FaceParser.from_state_dict(W.parsenet_state_dict_from_jax(params, 64, 2), in_size=64, res_depth=2,
                                         device="cpu")
    return jparser, tparser, params


def test_parsed_paste_back_matches_jax(parsers, monkeypatch):
    """ParsedPasteBack with a parser: the soft mask fused with the parse
    mask (the parser given the JAX class map, so an argmax tie cannot
    split them), pasted through the inverse affine."""
    from supir_tpu.utils.face_restore import FaceRestoreHelper, ParsedPasteBack

    jparser, tparser, _ = parsers
    rng = np.random.default_rng(5)
    img = rng.random((96, 128, 3)).astype(np.float32)
    jhelper = FaceRestoreHelper(face_size=64, detector=_two_faces)
    thelper = TF.FaceRestoreHelper(face_size=64, detector=_two_faces)
    jfaces, tfaces = jhelper.align_warp_faces(img), thelper.align_warp_faces(torch.from_numpy(img))
    restored = [rng.random((64, 64, 3)).astype(np.float32) for _ in jfaces]
    classes = []
    jforward = jparser._forward

    def recording(p, x):
        out = jforward(p, x)
        classes.append(np.asarray(out)[0].argmax(-1))
        return out

    monkeypatch.setattr(jparser, "_forward", recording)
    want = ParsedPasteBack(jhelper, parser=jparser)(img, jfaces, restored)
    replay = iter(classes)
    tparser_given = type("GivenClasses", (), {"parse_mask": lambda self, bgr: tparser.mask_from_classes(
        torch.from_numpy(next(replay)))})()
    got = TF.ParsedPasteBack(thelper, parser=tparser_given)(torch.from_numpy(img), tfaces,
                                                            [torch.from_numpy(r) for r in restored])
    np.testing.assert_allclose(got.numpy(), want, atol=PIXEL_ATOL, rtol=0)
    # the parser's own logits on such a face agree with JAX's
    bgr = restored[0][..., ::-1] * 255.0
    np.testing.assert_allclose(tparser.logits(bgr.copy()).permute(1, 2, 0).numpy(),
                               np.asarray(jforward(jparser.params, _parser_input(bgr, 64)))[0], atol=ATOL, rtol=RTOL)
    soft = TF.ParsedPasteBack(thelper)(torch.from_numpy(img), tfaces, [torch.from_numpy(r) for r in restored])
    assert np.abs(soft.numpy() - got.numpy()).max() > 1e-3  # the parse mask took part


def _parser_input(bgr, size):
    """FaceParser.parse_mask's input to the network (JAX side)."""
    import jax.numpy as jnp

    from supir_tpu.ops.resize import bilinear_resize

    face = (np.asarray(bgr, np.float32) / 255.0)[..., ::-1]
    face = (face - 0.5) / 0.5
    if face.shape[0] != size:
        face = np.asarray(bilinear_resize(jnp.asarray(face)[None], (size, size)))[0]
    return face[None]


def test_parsenet_logits_and_mask_match_jax(parsers):
    """ParseNet's logits and image at in_size 64, depth 2; the mask equal
    given JAX's class map, and equal outright where each pixel's top-2
    logit margin exceeds 1e-2 (random weights can leave two classes
    within fp32 noise of each other)."""
    import jax.numpy as jnp

    from supir_tpu.models.parsenet import ParseNet as JParseNet

    jparser, tparser, params = parsers
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jmask, jimg = JParseNet(in_size=64, res_depth=2).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        tmask, timg = tparser.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tmask.permute(0, 2, 3, 1).numpy(), np.asarray(jmask), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(timg.permute(0, 2, 3, 1).numpy(), np.asarray(jimg), atol=ATOL, rtol=RTOL)

    face = rng.integers(0, 256, (80, 80, 3)).astype(np.float32)  # resized to 64 inside
    want = jparser.parse_mask(face)
    logits = np.asarray(jparser._forward(jparser.params, _parser_input(face, 64)))[0]
    classes = logits.argmax(-1)
    given = tparser.mask_from_classes(torch.from_numpy(classes)).numpy()
    np.testing.assert_allclose(given, want, atol=PIXEL_ATOL, rtol=0)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-2
    assert clear.mean() > 0.9
    got_classes = tparser.logits(face).argmax(0).numpy()
    np.testing.assert_array_equal(got_classes[clear], classes[clear])
    got = tparser.parse_mask(face).numpy()
    assert got.shape == (64, 64) and got.min() >= 0 and got.max() <= 1 and got[:10].max() == 0
    if (got_classes == classes).all():
        np.testing.assert_allclose(got, want, atol=PIXEL_ATOL, rtol=0)


# ------------------------------------------------------------------ RetinaFace


@pytest.fixture(scope="module")
def retina_params():
    from supir_tpu.models.retinaface import RetinaFace as JRetinaFace

    return face_params(_shapes(JRetinaFace(), 64), seed=7)


@pytest.mark.parametrize("canvas", [128, 100])
def test_retinaface_matches_jax(retina_params, canvas):
    """loc, conf and landmarks at canvas 128 and at 100, no multiple of 32
    (its FPN resizes 4 -> 7 -> 13, where jax.image's nearest differs from
    F.interpolate's)."""
    import jax.numpy as jnp

    from supir_tpu.models.retinaface import RetinaFace as JRetinaFace

    x = np.random.default_rng(8).standard_normal((1, canvas, canvas, 3)).astype(np.float32) * 50
    want = JRetinaFace().apply({"params": retina_params}, jnp.asarray(x))
    model = RetinaFace()
    model.load_state_dict(W.retinaface_state_dict_from_jax(retina_params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_detect_faces_matches_jax(retina_params):
    """detect_faces at canvas 256 on a 200x300 uint8 image: the antialiased
    resize, the letterbox, the decode and NMS, at a threshold that keeps
    detections on random weights (the middle of the widest gap between the
    20th and 80th highest scores, so no score sits at it)."""
    import jax

    from supir_tpu.models.retinaface import RetinaFaceDetector as JDetector

    img = np.random.default_rng(9).integers(0, 256, (200, 300, 3)).astype(np.uint8)
    jdet = JDetector(jax.tree_util.tree_map(np.asarray, retina_params), canvas=256)
    tdet = RetinaFaceDetector.from_state_dict(W.retinaface_state_dict_from_jax(retina_params), canvas=256,
                                              device="cpu")
    (_, conf, _), _ = tdet.forward_canvas(img)
    s = np.sort(conf[0, :, 1].numpy())[::-1]
    k = 20 + int(np.argmax(s[19:79] - s[20:80]))
    threshold = float(s[k - 1] + s[k]) / 2
    want = jdet.detect_faces(img, conf_threshold=threshold)
    got = tdet.detect_faces(img, conf_threshold=threshold)
    assert want.shape[0] > 0 and got.shape == want.shape == (want.shape[0], 15)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=RTOL)  # pixel coordinates: ATOL x canvas scale


def test_detector_wrapper_matches_jax():
    """detector_from_models: [0, 1] RGB in, BGR 0-255 to the detector, the
    eye-distance filter and the largest/center selections."""
    from supir_tpu.utils.face_restore import detector_from_models as jwrap

    class FakeDet:
        def __init__(self):
            self.seen = []

        def detect_faces(self, img, conf_threshold=0.8, nms_threshold=0.4):
            self.seen.append(np.asarray(img).copy())
            rows = np.zeros((3, 15), np.float32)
            rows[0, :5], rows[0, 5:] = [20, 20, 90, 90, 0.99], [40, 40, 70, 40, 55, 58, 45, 72, 65, 72]
            rows[1, :5], rows[1, 5:] = [60, 10, 110, 100, 0.9], [70, 30, 95, 31, 82, 50, 74, 70, 90, 70]
            rows[2, :5], rows[2, 5:] = [0, 0, 8, 8, 0.95], [2, 2, 4, 2, 3, 4, 2, 6, 4, 6]  # eyes 2 px apart
            return rows

    img = np.random.default_rng(10).random((112, 120, 3)).astype(np.float32)
    for kw in ({}, {"only_keep_largest": True}, {"only_center_face": True}, {"eye_dist_threshold": None}):
        jd, td = FakeDet(), FakeDet()
        want = jwrap(jd, **kw)(img)
        got = TF.detector_from_models(td, **kw)(img)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(td.seen[0], jd.seen[0])
    assert len(TF.detector_from_models(FakeDet())(img)) == 2


# ------------------------------------------------------------------ converters


@pytest.fixture(scope="module")
def face_manifests():
    with open(ROOT / "supir_tpu" / "data" / "face_key_manifests.json") as f:
        return json.load(f)


def _synthetic(manifest, seed):
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32)) for k, shape in manifest.items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 1.0
    return sd


@pytest.mark.parametrize("which", ["retinaface", "parsenet"])
def test_face_converters_match_jax(which, face_manifests):
    """A facexlib-keyed dict at the manifest's shapes (with a `module.`
    prefix, num_batches_tracked and a stray key): the port's state dict
    equals the JAX converter's tree through the bridge bit for bit, the
    reports agree, it loads strict into the port's module; the rule keys
    are the manifest's; a missing key makes the loader raise."""
    from supir_tpu.utils import face_ckpt as JFC

    sd = _synthetic(face_manifests[which], seed=11)
    raw = {"module." + k: v for k, v in sd.items()}
    raw["module.stray.weight"] = torch.zeros(3)
    raw["module.body.bn1.num_batches_tracked" if which == "retinaface"
        else "module.body.0.conv1.norm.norm.num_batches_tracked"] = torch.tensor(7)
    jconvert = getattr(JFC, f"convert_{which}_state_dict")
    tconvert = getattr(TFC, f"convert_{which}_state_dict")
    jtree, jreport = jconvert({k: v.numpy() for k, v in raw.items()})
    got, report = tconvert(raw)
    assert {tk for tk, _, _ in getattr(TFC, f"{which}_rules")()} == set(face_manifests[which])
    assert getattr(TFC, f"{which}_rules")() == getattr(JFC, f"{which}_rules")()
    bridge = (W.retinaface_state_dict_from_jax if which == "retinaface" else W.parsenet_state_dict_from_jax)
    want = bridge(jtree)
    assert set(got) == set(want) == set(face_manifests[which])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert (report.filled, report.missing, report.unused) == (len(want), jreport.missing, jreport.unused)
    assert report.unused == ["stray.weight"]
    model = RetinaFace() if which == "retinaface" else ParseNet()
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("which", ["retinaface", "parsenet"])
def test_face_loaders_from_files(which, face_manifests, tmp_path):
    """load_retinaface / load_parsenet on torch-saved files: the weights
    land on the named device equal to what the JAX loader holds (through
    the bridge, bit for bit; one detect runs), a missing key raises."""
    from supir_tpu.utils import face_ckpt as JFC

    sd = _synthetic(face_manifests[which], seed=12)
    path = tmp_path / f"{which}.pth"
    torch.save(sd, path)
    jloaded = getattr(JFC, f"load_{which}")(str(path))
    bridge = W.retinaface_state_dict_from_jax if which == "retinaface" else W.parsenet_state_dict_from_jax
    for k, v in bridge(jloaded.params).items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    if which == "retinaface":
        det = TFC.load_retinaface(str(path), canvas=64, device="cpu")
        assert det.detect_faces(np.zeros((48, 40, 3), np.uint8)).shape[1] == 15
        torch.testing.assert_close(det.model.state_dict()["body.conv1.weight"], sd["body.conv1.weight"])
    else:
        parser = TFC.load_parsenet(str(path), device="cpu")
        assert parser.in_size == 512 and len(parser.model.body) == 10
        for k, v in parser.model.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    del sd[next(iter(sd))]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="missing 1 keys"):
        getattr(TFC, f"load_{which}")(str(path), device="cpu")


def test_face_models_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetinaFaceDetector.create(canvas=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceParser.create(in_size=64, res_depth=1)


# ------------------------------------------------------------------ restore_with_faces


@pytest.fixture(scope="module")
def tiny_engines():
    from torch_parity import tiny_engine_pair

    return tiny_engine_pair()


def test_restore_with_faces_matches_jax(tiny_engines, parsers, monkeypatch):
    """Two faces (a landmark callable) restored at 64 and the 64x64
    background: three batchify_sample calls with the same injected noise in
    both packages; pasted with the border mask, then with the parse mask
    (the JAX parser's class maps replayed into the port's)."""
    from supir_tpu.apps.face_demo import restore_with_faces as jrestore
    from torch_parity import inject_noise

    cfg, jengine, tcfg, tengine = tiny_engines
    jparser, tparser, _ = parsers
    image = np.random.default_rng(13).uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    kw = dict(prompt="a portrait", face_resolution=64, num_steps=2, cfg_scale=4.0, seed=3, detector=_two_faces)

    jcalls = inject_noise(jengine)
    tcalls = inject_noise(tengine)
    want = jrestore(jengine, cfg, image, **kw)
    got = restore_with_faces(tengine, tcfg, torch.from_numpy(image), **kw)
    assert jcalls == tcalls == [(1, 8, 8, 4)] * 3
    assert got.shape == (64, 64, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=SLICE_BOUND, rtol=0)

    classes = []
    jforward = jparser._forward

    def recording(p, x):
        out = jforward(p, x)
        classes.append(np.asarray(out)[0].argmax(-1))
        return out

    monkeypatch.setattr(jparser, "_forward", recording)
    jcalls.clear(), tcalls.clear()
    want_p = jrestore(jengine, cfg, image, parser=jparser, **kw)
    replay = iter(classes)
    given = type("GivenClasses", (), {"parse_mask": lambda self, bgr: tparser.mask_from_classes(
        torch.from_numpy(next(replay)))})()
    got_p = restore_with_faces(tengine, tcfg, image, parser=given, **kw)
    assert len(classes) == 2
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=SLICE_BOUND, rtol=0)
    assert np.abs(want_p - want).max() > 1e-3


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the face path's entry points run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_face_models_on_the_card_match_cpu(cuda):
    """RetinaFace (canvas 128), ParseNet (64, depth 2), the warp and the
    soft mask on the card in fp32 against the same on the CPU."""
    det_cpu = RetinaFaceDetector.create(seed=1, canvas=128, device="cpu")
    det = RetinaFaceDetector.from_state_dict(det_cpu.model.state_dict(), canvas=128, device=cuda)
    img = np.random.default_rng(14).integers(0, 256, (100, 90, 3)).astype(np.uint8)
    (got, _), (want, _) = det.forward_canvas(img), det_cpu.forward_canvas(img)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=ATOL, rtol=RTOL)
    parser_cpu = FaceParser.create(seed=2, in_size=64, res_depth=2, device="cpu")
    parser = FaceParser.from_state_dict(parser_cpu.model.state_dict(), in_size=64, res_depth=2, device=cuda)
    face = np.random.default_rng(15).integers(0, 256, (64, 64, 3)).astype(np.float32)
    torch.testing.assert_close(parser.logits(face).cpu(), parser_cpu.logits(face), atol=ATOL, rtol=RTOL)
    x = torch.rand(50, 70, 3)
    m = np.array([[1.2, 0.3, -10.0], [-0.2, 1.1, 5.0]], np.float32)
    torch.testing.assert_close(TF.warp_affine(x.to(cuda), m, (60, 80)).cpu(), TF.warp_affine(x, m, (60, 80)),
                               atol=PIXEL_ATOL, rtol=0)
    torch.testing.assert_close(TF.soft_erosion_mask(128, 1, cuda).cpu(), TF.soft_erosion_mask(128, 1),
                               atol=PIXEL_ATOL, rtol=0)
