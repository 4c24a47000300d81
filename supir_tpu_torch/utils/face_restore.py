"""Face restoration helper (counterpart of supir_tpu/utils/face_restore.py;
behavioural contract SUPIR/utils/face_restoration_helper.py:49-513):
detect 5 facial landmarks, similarity-align each face to the 512x512 FFHQ
template scaled to the face size, restore the crop, paste it back through
the inverse affine with a soft mask.

The landmark geometry is host numpy, the JAX package's code
(`umeyama_similarity`, `invert_affine`, `center_face_landmarks`,
`landmarks_from_detections`). The pixels stay on the images' device in
torch: `warp_affine` is `map_coordinates(order=1, mode="nearest")` written
out (bilinear, each of the four taps' indices clamped to the edge;
`F.grid_sample` normalises coordinates and treats the edges its own way),
the paste masks, `soft_erosion_mask`'s blur and ParseNet's mask. Images
are [H, W, C] fp32 in [0, 1]. A detector is any callable that takes a host
numpy copy of the image and returns [N, 5, 2] landmarks;
`detector_from_models` wraps a RetinaFaceDetector into one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from supir_tpu_torch.ops.resize import bilinear_resize, gaussian_blur

# FFHQ-style 5-landmark template for a 512x512 face crop
FACE_TEMPLATE_512 = np.array(
    [
        [192.98138, 239.94708],
        [318.90277, 240.19366],
        [256.63416, 314.01935],
        [201.26117, 371.41043],
        [313.08905, 371.15118],
    ],
    np.float32,
)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Closed-form similarity transform (scale + rotation + translation)
    mapping src -> dst, a 2x3 matrix (Umeyama 1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    r = u @ diag @ vt
    var_s = (sc ** 2).sum() / len(src)
    scale = np.trace(np.diag(s) @ diag) / var_s
    t = mu_d - scale * r @ mu_s
    m = np.zeros((2, 3))
    m[:2, :2] = scale * r
    m[:, 2] = t
    return m.astype(np.float32)


def invert_affine(m: np.ndarray) -> np.ndarray:
    a = np.eye(3, dtype=np.float64)
    a[:2] = m
    return np.linalg.inv(a)[:2].astype(np.float32)


def warp_affine(img: torch.Tensor, m: np.ndarray, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Warp img [H, W, C] by the 2x3 matrix m (src -> dst coordinates) to
    [out_h, out_w, C] on img's device: each output pixel samples the input
    at m^-1 (x, y) bilinearly, the four taps' indices clamped to the image
    (mode "nearest"), in fp32 as jax.scipy's map_coordinates does."""
    img = img.float()
    minv = [float(v) for v in invert_affine(m).reshape(-1)]
    h, w = img.shape[:2]
    oh, ow = out_hw
    dev = img.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[:, None].expand(oh, ow)
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, :].expand(oh, ow)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    src_x = f32(minv[0]) * xs + f32(minv[1]) * ys + f32(minv[2])
    src_y = f32(minv[3]) * xs + f32(minv[4]) * ys + f32(minv[5])
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0, src_x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy = [y0.long().clamp(0, h - 1), (y0.long() + 1).clamp(0, h - 1)]
    ix = [x0.long().clamp(0, w - 1), (x0.long() + 1).clamp(0, w - 1)]
    out = None
    for a, wy in zip(iy, (wy0, wy1)):
        for b, wx in zip(ix, (wx0, wx1)):
            term = img[a, b] * (wy * wx)[..., None]
            out = term if out is None else out + term
    return out


def center_face_landmarks(img) -> np.ndarray:
    """Fallback detector: one face assumed centered, spanning ~60% of the
    shorter side. Returns [1, 5, 2]."""
    h, w = img.shape[:2]
    side = min(h, w) * 0.6
    scale = side / 512.0
    lm = (FACE_TEMPLATE_512 - 256.0) * scale + np.array([w / 2, h / 2], np.float32)
    return lm[None]


@dataclasses.dataclass
class AlignedFace:
    crop: torch.Tensor        # [S, S, C] aligned face crop, on the image's device
    affine: np.ndarray        # 2x3 input -> crop matrix


def _border_mask(s: int) -> np.ndarray:
    border = max(s // 20, 4)
    mask = np.ones((s, s), np.float32)
    ramp = np.linspace(0, 1, border, dtype=np.float32)
    mask[:border] *= ramp[:, None]
    mask[-border:] *= ramp[::-1][:, None]
    mask[:, :border] *= ramp[None]
    mask[:, -border:] *= ramp[::-1][None]
    return mask


class FaceRestoreHelper:
    """Crop and align faces, paste restored ones back (reference
    FaceRestoreHelper)."""

    def __init__(self, face_size: int = 512, detector: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.face_size = face_size
        self.detector = detector or center_face_landmarks
        self.template = FACE_TEMPLATE_512 * (face_size / 512.0)

    def get_face_landmarks_5(self, img: torch.Tensor) -> np.ndarray:
        host = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
        return np.asarray(self.detector(host), np.float32)

    def align_warp_faces(self, img: torch.Tensor) -> List[AlignedFace]:
        faces = []
        for lm in self.get_face_landmarks_5(img):
            m = umeyama_similarity(lm, self.template)
            faces.append(AlignedFace(crop=warp_affine(img, m, (self.face_size, self.face_size)), affine=m))
        return faces

    def paste_faces_to_input_image(self, img: torch.Tensor, faces: List[AlignedFace],
                                   restored: List[torch.Tensor]) -> torch.Tensor:
        """Inverse-affine paste-back with a soft border mask."""
        out = img.float().clone()
        mask = torch.from_numpy(_border_mask(self.face_size)).to(img.device)[:, :, None]
        for face, rest in zip(faces, restored):
            inv = invert_affine(face.affine)
            back = warp_affine(rest, inv, img.shape[:2])
            m_back = warp_affine(mask, inv, img.shape[:2]).clamp(0.0, 1.0)
            out = out * (1 - m_back) + back * m_back
        return out


# ---------------------------------------------------------------------------
# detector-driven landmark extraction + parse-mask paste-back
# (reference get_face_landmarks_5 / paste_faces_to_input_image,
#  face_restoration_helper.py:186-470)


def get_largest_face(det_faces: np.ndarray, h: int, w: int) -> int:
    def area(bb):
        left, top = max(bb[0], 0), max(bb[1], 0)
        right, bottom = min(bb[2], w), min(bb[3], h)
        return (right - left) * (bottom - top)

    return int(np.argmax([area(b) for b in det_faces]))


def get_center_face(det_faces: np.ndarray, h: int, w: int) -> int:
    center = np.array([w / 2, h / 2])
    dists = [np.linalg.norm(np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2]) - center) for b in det_faces]
    return int(np.argmin(dists))


def landmarks_from_detections(bboxes: np.ndarray, image_hw: Tuple[int, int], only_keep_largest: bool = False,
                              only_center_face: bool = False,
                              eye_dist_threshold: Optional[float] = None) -> np.ndarray:
    """[N, 15] detect_faces rows -> [M, 5, 2] landmark sets, with the
    reference's eye-distance filter and largest/center selection."""
    landmarks, det = [], []
    for bb in np.asarray(bboxes, np.float32):
        eye_dist = np.linalg.norm([bb[6] - bb[8], bb[7] - bb[9]])
        if eye_dist_threshold is not None and eye_dist < eye_dist_threshold:
            continue
        landmarks.append(bb[5:15].reshape(5, 2))
        det.append(bb[0:5])
    if not landmarks:
        return np.zeros((0, 5, 2), np.float32)
    h, w = image_hw
    if only_keep_largest:
        i = get_largest_face(np.stack(det), h, w)
        return np.stack(landmarks[i:i + 1])
    if only_center_face:
        i = get_center_face(np.stack(det), h, w)
        return np.stack(landmarks[i:i + 1])
    return np.stack(landmarks)


def detector_from_models(retinaface, eye_dist_threshold: Optional[float] = 5.0,
                         only_center_face: bool = False, only_keep_largest: bool = False):
    """A RetinaFaceDetector as the helper's landmark callable, with the
    reference demo's eye_dist_threshold 5 (gradio_demo_face.py:103). Its
    resize, 640 there, is the detector's canvas (`RetinaFaceDetector(canvas=)`,
    `load_retinaface(canvas=)`)."""

    def detect(img: np.ndarray) -> np.ndarray:
        bgr = np.asarray(img, np.float32)
        if bgr.max() <= 1.5:  # [0, 1] float input
            bgr = bgr * 255.0
        bboxes = retinaface.detect_faces(bgr[..., ::-1])  # RGB -> BGR
        return landmarks_from_detections(bboxes, bgr.shape[:2], only_keep_largest=only_keep_largest,
                                         only_center_face=only_center_face,
                                         eye_dist_threshold=eye_dist_threshold)

    return detect


def soft_erosion_mask(face_size: int, upscale_factor: int = 1, device=None) -> torch.Tensor:
    """The reference's square fusion mask in crop space: all ones, a border
    of 2 * upscale zeroed, then eroded and blurred by the area-scaled edge
    width (face_restoration_helper.py:421-445), on `device`."""
    mask = np.ones((face_size, face_size), np.float32)
    e1 = int(2 * upscale_factor)
    mask[:e1], mask[-e1:], mask[:, :e1], mask[:, -e1:] = 0, 0, 0, 0
    total_face_area = (face_size - 2 * e1) ** 2
    w_edge = int(total_face_area ** 0.5) // 20
    er = w_edge * 2
    if er > 0:
        center = np.zeros_like(mask)
        center[er:-er, er:-er] = mask[er:-er, er:-er]
    else:
        center = mask
    center = torch.from_numpy(center).to(device)
    blur = w_edge * 2 + 1
    if blur > 1:
        center = gaussian_blur(center[None, :, :, None], ksize=blur,
                               sigma=0.3 * ((blur - 1) * 0.5 - 1) + 0.8)[0, :, :, 0]
    return center


def _resize_hw(x: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, C] -> [size, size, C], jax.image's bilinear without antialias."""
    return bilinear_resize(x.permute(2, 0, 1)[None], (size, size))[0].permute(1, 2, 0)


class ParsedPasteBack:
    """paste_faces_to_input_image with the ParseNet soft mask (reference
    use_parse branch, face_restoration_helper.py:446-470)."""

    def __init__(self, helper: FaceRestoreHelper, parser=None, upscale_factor: int = 1):
        self.helper = helper
        self.parser = parser
        self.upscale = upscale_factor

    def __call__(self, img: torch.Tensor, faces: List[AlignedFace], restored: List[torch.Tensor]) -> torch.Tensor:
        out = img.float().clone()
        s = self.helper.face_size
        soft = soft_erosion_mask(s, self.upscale, img.device)[:, :, None]
        for face, rest in zip(faces, restored):
            inv = invert_affine(face.affine)
            back = warp_affine(rest, inv, img.shape[:2])
            inv_soft = warp_affine(soft, inv, img.shape[:2]).clamp(0, 1)
            if self.parser is not None:
                face512 = rest.float() if rest.shape[0] == 512 else _resize_hw(rest.float(), 512)
                bgr = face512.flip(-1) * 255.0 if bool(face512.max() <= 1.5) else face512.flip(-1)
                pm = self.parser.parse_mask(bgr)
                if pm.shape[0] != s:
                    pm = _resize_hw(pm[:, :, None], s)[:, :, 0]
                inv_parse = warp_affine(pm[:, :, None], inv, img.shape[:2]).clamp(0, 1)
                # fuse: take the parse mask where it is tighter
                inv_soft = torch.where(inv_parse < inv_soft, inv_parse, inv_soft)
            out = out * (1 - inv_soft) + back * inv_soft
        return out
