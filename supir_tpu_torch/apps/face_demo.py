"""Face restoration (counterpart of supir_tpu/apps/face_demo.py; the
reference gradio_demo_face.py flow, :180-214): align and crop each
detected face, restore it at `face_resolution`, optionally restore the
background, paste the faces back through the inverse affine.

Everything runs on the engine's device: the warps and masks
(`utils/face_restore.py`), RetinaFace and ParseNet where they are given,
and one `batchify_sample` per face and one for the background.
"""

from __future__ import annotations

import torch

from supir_tpu_torch.utils.face_restore import FaceRestoreHelper, ParsedPasteBack, detector_from_models
from supir_tpu_torch.utils.tokenizer import tokenize


def restore_with_faces(engine, cfg, image, prompt: str = "", face_resolution: int = 1024, num_steps: int = 50,
                       cfg_scale: float = 7.5, seed: int = 0, restore_background: bool = True, detector=None,
                       parser=None) -> torch.Tensor:
    """image [H, W, 3] in [-1, 1] (numpy or a tensor) -> the restored image
    [H, W, 3] in [-1, 1], fp32 on the engine's device.

    `detector`: a landmark callable, a RetinaFaceDetector (wrapped by
    detector_from_models with the reference demo's settings), or None for
    the geometric center-face fallback. `parser`: an optional FaceParser
    for the parse-mask paste-back (the reference's use_parse branch)."""
    if detector is not None and hasattr(detector, "detect_faces"):
        detector = detector_from_models(detector)
    helper = FaceRestoreHelper(face_size=face_resolution, detector=detector)
    image = engine._tensor(image)
    img01 = (image + 1.0) / 2.0
    faces = helper.align_warp_faces(img01)
    tok_p = tokenize([prompt + cfg.p_p])
    tok_n = tokenize([cfg.n_p])

    def run(x: torch.Tensor) -> torch.Tensor:
        x = x[None]
        z = engine.encode_first_stage_with_denoise(x)
        c, uc = engine.prepare_condition(z, tok_p, tok_p, tok_n, tok_n)
        out = engine.batchify_sample(x, c, uc, num_steps=num_steps, cfg_scale=cfg_scale, seed=seed,
                                     color_fix_type="Wavelet", z_override=z)
        return out[0]

    restored = [(run(f.crop * 2.0 - 1.0) + 1.0) / 2.0 for f in faces]
    base = (run(image) + 1.0) / 2.0 if restore_background else img01
    if parser is not None:
        merged = ParsedPasteBack(helper, parser=parser)(base, faces, restored)
    else:
        merged = helper.paste_faces_to_input_image(base, faces, restored)
    return (merged * 2.0 - 1.0).clamp(-1.0, 1.0)
