"""Host-side image transforms (PIL/numpy).

A copy of vit_search_tpu/data/transforms.py: the same draws from the same
generator give the same bytes.

Covers the reference training/eval pipelines (datasets.py:104-141, timm
``create_transform`` with defaults from main.py:138-159):

train: RandomResizedCrop(bicubic/random interp) -> HFlip -> RandAugment
       ('rand-m9-mstd0.5-inc1') -> [normalize] -> RandomErasing(0.25, pixel)
eval:  Resize(256/224 * size, bicubic) -> CenterCrop(size)

Outputs are uint8 HWC numpy arrays; normalization runs on the device (in
the train step) so host-to-device copies stay 4x smaller than float32.
RandomErasing operates in normalized space in timm, so it is also deferred
to device (see data/erasing.py) — the host pipeline stays uint8 end to end.

All randomness flows through explicit ``numpy.random.Generator`` instances.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_INTERPOLATIONS = (Image.BILINEAR, Image.BICUBIC)


# --- RandAugment -------------------------------------------------------------
#
# Pinned to timm 0.3.2 auto_augment.py semantics for the reference's policy
# 'rand-m9-mstd0.5-inc1' (reference datasets.py create_transform defaults,
# main.py:138-144):
# - 2 layers per image, each op drawn uniformly from the 15
#   _RAND_INCREASING_TRANSFORMS and APPLIED WITH PROBABILITY 0.5;
# - per-application magnitude ~ N(m, mstd) clipped to [0, 10];
# - 'inc1' (increasing-severity) level->arg mappings, including
#   posterize "bits kept" = 4 - int(4*level/10) and solarize threshold
#   256 - int(256*level/10);
# - geometric ops resample with the pipeline interpolation (bicubic for the
#   published recipes; 'random' -> per-application bilinear/bicubic pick)
#   and fill with round(255 * IMAGENET_MEAN) = (124, 116, 104).

_MAX_LEVEL = 10.0

_RA_FILL = tuple(min(255, round(255 * m)) for m in IMAGENET_MEAN)  # (124,116,104)


class RandAugment:
    def __init__(self, num_ops: int = 2, magnitude: float = 9.0,
                 mag_std: float = 0.5, prob: float = 0.5,
                 fill: Tuple[int, int, int] = _RA_FILL,
                 interpolation: str = "bicubic"):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.mag_std = mag_std
        self.prob = prob
        self.fill = fill
        self.interpolation = interpolation
        self.ops = [
            self._auto_contrast, self._equalize, self._invert,
            self._rotate, self._posterize, self._solarize, self._solarize_add,
            self._color, self._contrast, self._brightness, self._sharpness,
            self._shear_x, self._shear_y, self._translate_x, self._translate_y,
        ]

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        for _ in range(self.num_ops):
            op = self.ops[int(rng.integers(len(self.ops)))]
            if self.prob < 1.0 and rng.random() > self.prob:
                continue  # timm AugmentOp: each op applies with prob 0.5
            level = self.magnitude
            if self.mag_std > 0:
                level = float(rng.normal(self.magnitude, self.mag_std))
            level = float(np.clip(level, 0.0, _MAX_LEVEL))
            img = op(img, level, rng)
        return img

    def _resample(self, rng):
        if self.interpolation == "random":
            return _INTERPOLATIONS[int(rng.integers(2))]
        return _INTERP_BY_NAME.get(self.interpolation, Image.BICUBIC)

    # -- ops (each takes (img, level, rng)) --
    def _auto_contrast(self, img, level, rng):
        return ImageOps.autocontrast(img)

    def _equalize(self, img, level, rng):
        return ImageOps.equalize(img)

    def _invert(self, img, level, rng):
        return ImageOps.invert(img)

    def _rotate(self, img, level, rng):
        degrees = 30.0 * level / _MAX_LEVEL
        if rng.random() < 0.5:
            degrees = -degrees
        return img.rotate(degrees, resample=self._resample(rng),
                          fillcolor=self.fill)

    @staticmethod
    def posterize_bits(level: float) -> int:
        """'inc1' bits-to-keep (timm _posterize_increasing_level_to_arg):
        4 - int(4*level/10); m9 keeps 1 bit, >=8 is a no-op."""
        return 4 - int(4 * level / _MAX_LEVEL)

    def _posterize(self, img, level, rng):
        bits = self.posterize_bits(level)
        if bits >= 8:
            return img
        return ImageOps.posterize(img, bits)

    @staticmethod
    def solarize_thresh(level: float) -> int:
        """'inc1' threshold (timm _solarize_increasing_level_to_arg):
        256 - int(256*level/10); m9 -> 26."""
        return 256 - int(256 * level / _MAX_LEVEL)

    def _solarize(self, img, level, rng):
        return ImageOps.solarize(img, self.solarize_thresh(level))

    def _solarize_add(self, img, level, rng):
        add = int(level / _MAX_LEVEL * 110)
        arr = np.asarray(img).astype(np.int32)
        arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
        return Image.fromarray(arr.astype(np.uint8))

    @staticmethod
    def enhance_factor(level: float, negate: bool) -> float:
        """'inc1' enhance factor (timm _enhance_increasing_level_to_arg):
        1 +/- 0.9*level/10."""
        v = 0.9 * level / _MAX_LEVEL
        return 1.0 - v if negate else 1.0 + v

    def _enhance(self, cls, img, level, rng):
        factor = self.enhance_factor(level, rng.random() < 0.5)
        return cls(img).enhance(factor)

    def _color(self, img, level, rng):
        return self._enhance(ImageEnhance.Color, img, level, rng)

    def _contrast(self, img, level, rng):
        return self._enhance(ImageEnhance.Contrast, img, level, rng)

    def _brightness(self, img, level, rng):
        return self._enhance(ImageEnhance.Brightness, img, level, rng)

    def _sharpness(self, img, level, rng):
        return self._enhance(ImageEnhance.Sharpness, img, level, rng)

    def _affine(self, img, matrix, rng):
        return img.transform(img.size, Image.AFFINE, matrix,
                             resample=self._resample(rng), fillcolor=self.fill)

    def _shear_x(self, img, level, rng):
        s = 0.3 * level / _MAX_LEVEL * (1 if rng.random() < 0.5 else -1)
        return self._affine(img, (1, s, 0, 0, 1, 0), rng)

    def _shear_y(self, img, level, rng):
        s = 0.3 * level / _MAX_LEVEL * (1 if rng.random() < 0.5 else -1)
        return self._affine(img, (1, 0, 0, s, 1, 0), rng)

    def _translate_x(self, img, level, rng):
        t = 0.45 * level / _MAX_LEVEL * img.size[0]
        t = t if rng.random() < 0.5 else -t
        return self._affine(img, (1, 0, t, 0, 1, 0), rng)

    def _translate_y(self, img, level, rng):
        t = 0.45 * level / _MAX_LEVEL * img.size[1]
        t = t if rng.random() < 0.5 else -t
        return self._affine(img, (1, 0, 0, 0, 1, t), rng)


# --- crop/resize -----------------------------------------------------------------


_INTERP_BY_NAME = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}


def random_resized_crop(img: Image.Image, size: int, rng: np.random.Generator,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                        interpolation: str = "random") -> Image.Image:
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            if interpolation == "random":
                interp = _INTERPOLATIONS[int(rng.integers(2))]
            else:
                interp = _INTERP_BY_NAME.get(interpolation, Image.BICUBIC)
            return img.resize((size, size), interp,
                              box=(x, y, x + cw, y + ch))
    # fallback: center crop
    return center_crop_resize(img, size)


def center_crop_resize(img: Image.Image, size: int,
                       crop_pct: float = 224 / 256) -> Image.Image:
    """Eval transform: resize shorter side to size/crop_pct, center crop."""
    scale_size = int(math.floor(size / crop_pct))
    w, h = img.size
    if w <= h:
        nw, nh = scale_size, int(round(scale_size * h / w))
    else:
        nw, nh = int(round(scale_size * w / h)), scale_size
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


# --- composed pipelines ------------------------------------------------------------


class TrainTransform:
    """RandomResizedCrop + HFlip + RandAugment -> uint8 HWC."""

    def __init__(self, size: int = 224, rand_augment: Optional[str] = "rand-m9-mstd0.5-inc1",
                 color_jitter: float = 0.4, hflip: bool = True,
                 interpolation: str = "bicubic"):
        self.size = size
        self.hflip = hflip
        self.interpolation = interpolation
        self.rand_augment = None
        self.color_jitter = 0.0
        if rand_augment:
            params = _parse_rand_augment(rand_augment)
            self.rand_augment = RandAugment(interpolation=interpolation, **params)
        else:
            # timm only applies color jitter when auto-augment is off
            self.color_jitter = color_jitter

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> np.ndarray:
        img = img.convert("RGB")
        img = random_resized_crop(img, self.size, rng,
                                  interpolation=self.interpolation)
        if self.hflip and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.rand_augment is not None:
            img = self.rand_augment(img, rng)
        elif self.color_jitter > 0:
            for enhancer in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                             ImageEnhance.Color):
                factor = 1.0 + float(rng.uniform(-self.color_jitter, self.color_jitter))
                img = enhancer(img).enhance(max(0.0, factor))
        return np.asarray(img, dtype=np.uint8)


class EvalTransform:
    def __init__(self, size: int = 224, crop_pct: float = 224 / 256):
        self.size = size
        self.crop_pct = crop_pct

    def __call__(self, img: Image.Image,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        img = img.convert("RGB")
        img = center_crop_resize(img, self.size, self.crop_pct)
        return np.asarray(img, dtype=np.uint8)


def _parse_rand_augment(spec: str) -> dict:
    """Parse timm-style 'rand-m9-mstd0.5-inc1' policy strings."""
    params = {"magnitude": 9.0, "mag_std": 0.5, "num_ops": 2}
    for part in spec.split("-")[1:]:
        if part.startswith("mstd"):
            params["mag_std"] = float(part[4:])
        elif part.startswith("m"):
            params["magnitude"] = float(part[1:])
        elif part.startswith("n"):
            params["num_ops"] = int(part[1:])
        elif part.startswith("inc"):
            pass  # increasing-severity is this implementation's default
    return params
