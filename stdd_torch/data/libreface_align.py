"""LibreFace standalone alignment helper (FaceMesh → FFHQ-style crop).

Port of ``stdd_tpu/data/libreface_align.py`` (the reference's
``preprocessing/libreface/detect_mediapipe_image.py``): the eye-ring and
lip landmark subsets of the dense mesh (the public
FACEMESH_{LEFT_EYE,RIGHT_EYE,LIPS} edge tables, :152-183) and the classic
FFHQ similarity-aligned face crop (``image_align`` :18) plus the landmark
arrays, the input the standalone LibreFace AU CLI consumes.

The dense landmarks come from :class:`stdd_torch.models.facemesh.
DenseLandmarker` and the detection from the port's YuNet, both on the card
unless ``device="cpu"``. The warp stays on the host, as JAX's does, in the
port's numpy twins of cv2 (``ops/align.py``): ``getPerspectiveTransform``
bit for bit, ``warpPerspective`` (INTER_LINEAR, zero border) within one
grey level on fewer than 5e-4 of the values, and the INTER_AREA step to the output
size bit for bit. Images are read and written as PNG by
:mod:`stdd_torch.utils.image_io`. The JAX module's deviations from the
reference are kept: zero padding outside the frame, and the crop saved at
``output_size``.

CLI, on the card::

    python -m stdd_torch.data.libreface_align --image face.png --out_dir tmp \
        [--au_ckpt random] [--device cpu]
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.align import perspective_transform, resize_u8, warp_perspective_u8

# FaceMesh index subsets, derived from the public FACEMESH_* edge tables
# (detect_mediapipe_image.py:152-183; first-appearance order preserved)
RIGHT_EYE_IDX = [33, 7, 163, 144, 145, 153, 154, 155, 133,
                 246, 161, 160, 159, 158, 157, 173]      # image-left ring
LEFT_EYE_IDX = [263, 249, 390, 373, 374, 380, 381, 382, 362,
                466, 388, 387, 386, 385, 384, 398]       # image-right ring
LIPS_IDX = [61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291,
            185, 40, 39, 37, 0, 267, 269, 270, 409,
            78, 95, 88, 178, 87, 14, 317, 402, 318, 324, 308,
            191, 80, 81, 82, 13, 312, 311, 310, 415]


def image_align(img_rgb: np.ndarray, landmarks_72: np.ndarray,
                output_size: int = 256, transform_size: int = 512,
                x_scale: float = 1.0, y_scale: float = 1.0,
                em_scale: float = 0.1) -> np.ndarray:
    """FFHQ-style face alignment (reference image_align, :18).

    ``landmarks_72``: [16 right-eye ring, 16 left-eye ring, 40 lips] points
    in pixel coordinates. The oriented crop quad is the public FFHQ recipe:
    eye-to-eye and eye-to-mouth vectors set the rotation and scale.
    """
    lm = np.asarray(landmarks_72, np.float64)
    eye_r = lm[0:16].mean(axis=0)        # image-left eye (33-ring)
    eye_l = lm[16:32].mean(axis=0)       # image-right eye (263-ring)
    mouth = lm[32:]
    li = int(np.argmin(mouth[:, 0]))
    ri = int(np.argmax(mouth[:, 0]))
    mouth_avg = (mouth[li] + mouth[ri]) / 2.0

    eye_avg = (eye_l + eye_r) * 0.5
    eye_to_eye = eye_l - eye_r
    eye_to_mouth = mouth_avg - eye_avg
    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    n = np.hypot(*x)
    if n < 1e-6:
        raise ValueError("degenerate face geometry")
    x /= n
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    x *= x_scale
    y = np.flipud(x) * [-y_scale, y_scale]
    c = eye_avg + eye_to_mouth * em_scale
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])

    dst = np.asarray(
        [[0, 0], [0, transform_size], [transform_size, transform_size],
         [transform_size, 0]], np.float32)
    M = perspective_transform(quad.astype(np.float32), dst)
    out = warp_perspective_u8(np.asarray(img_rgb), M, (transform_size, transform_size))
    if output_size != transform_size:
        out = resize_u8(out, (output_size, output_size), "area")
    return out


def get_aligned_image(
    image, landmarker=None, detector=None, out_size: int = 256, device="cuda",
) -> Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """One image → (aligned [S,S,3] RGB, landmark dict) or None if no face.

    ``image``: a PNG path or an RGB array. The landmark dict mirrors the
    reference's saved structure: full 478-point array + the eye/lip subsets.
    The default landmarker (the packaged one) and detector (YuNet at a 0.5
    threshold) run on ``device``.
    """
    from ..models.yunet import detect_scaled

    if isinstance(image, str):
        from ..utils.image_io import imread

        if not os.path.exists(image):
            raise FileNotFoundError(image)
        img_rgb = imread(image)[:, :, ::-1].copy()
    else:
        img_rgb = np.asarray(image)

    if landmarker is None:
        from ..models.facemesh import DenseLandmarker

        landmarker = DenseLandmarker.pretrained(device=device)
    if detector is None:
        from ..config import DetectorConfig
        from ..models.yunet import DEFAULT_MODEL, YuNet

        detector = YuNet(DEFAULT_MODEL, DetectorConfig(conf_threshold=0.5), device=device)

    rows = detect_scaled(detector, np.ascontiguousarray(img_rgb[:, :, ::-1]))
    if not rows.size:
        return None
    r = rows[np.argmax(rows[:, 14])]
    tlbr = (r[0], r[1], r[0] + r[2], r[1] + r[3])

    dense = landmarker(img_rgb, tlbr)
    lm72 = np.concatenate(
        [dense[RIGHT_EYE_IDX], dense[LEFT_EYE_IDX], dense[LIPS_IDX]], axis=0)
    aligned = image_align(img_rgb, lm72, output_size=out_size)
    return aligned, {
        "landmarks": dense,
        "right_eye": dense[RIGHT_EYE_IDX],
        "left_eye": dense[LEFT_EYE_IDX],
        "lips": dense[LIPS_IDX],
    }


def main(argv=None):
    import argparse

    from ..utils.image_io import imwrite

    ap = argparse.ArgumentParser(
        description="FaceMesh-aligned face crop (+optional LibreFace AUs)")
    ap.add_argument("--image", required=True, help="a PNG image")
    ap.add_argument("--out_dir", default="./tmp")
    ap.add_argument("--out_size", type=int, default=256)
    ap.add_argument("--au_ckpt", default=None,
                    help="LibreFace AU checkpoint; 'random' for random init")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the detector, the landmarker and the AU model "
                         "(default: the card)")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    res = get_aligned_image(args.image, out_size=args.out_size, device=args.device)
    if res is None:
        print("no face detected")
        return 1
    aligned, lms = res
    stem = os.path.splitext(os.path.basename(args.image))[0]
    img_path = os.path.join(args.out_dir, f"{stem}_aligned.png")
    lmk_path = os.path.join(args.out_dir, f"{stem}_landmark.npy")
    imwrite(img_path, aligned[:, :, ::-1])
    np.save(lmk_path, lms["landmarks"])
    print(f"aligned → {img_path}; landmarks → {lmk_path}")

    if args.au_ckpt:
        from ..models.au_resnet import AUExtractor

        au = (AUExtractor.random_init(device=args.device) if args.au_ckpt == "random"
              else AUExtractor.from_torch_checkpoint(args.au_ckpt, device=args.device))
        # the extractor owns the LibreFace transform (Resize 256 +
        # CenterCrop 224): feed the aligned crop as-is; a pre-resize here
        # would round-trip 256→224→256 and shift borderline activations
        print("AUs:", au(aligned[None])[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
