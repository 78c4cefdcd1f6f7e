"""Host-side batch transforms between the shard stream and the device, the
port of ``serverless_learn_tpu/data/transforms.py``. Shards carry storage
dtypes (uint8 images, int32 token ids); the models want float tensors and
task-shaped fields:

* image classification: uint8 ``[B, H, W, C]`` -> float32 in [0, 1)
  (or uint8 left for the device to normalise), with a training-time
  random crop and horizontal flip (:func:`image_transform`);
* masked LM: ``{"input_ids"}`` -> ``{tokens, labels, mlm_mask,
  attn_mask}``, masked anew every pass (:func:`mlm_transform`);
* causal LM: ``{"input_ids"}`` -> ``{"tokens"}`` (:func:`lm_transform`).

:func:`auto_transform` picks the bridge from a dataset's fields and the
model's input spec. Each random transform draws from numpy's generator
seeded as the reference's (``(seed, 0xA46)`` for images, ``(seed,
0xB3A7)`` for MLM), so the same seed gives the same batches bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np

from serverless_learn_tpu_torch.data.raw import MASK_ID


class TransformedSource:
    """A batch source with a per-batch transform; forwards ``close``."""

    def __init__(self, source, fn: Callable[[Dict[str, np.ndarray]],
                                            Dict[str, np.ndarray]]):
        self.source = source
        self.fn = fn

    def __iter__(self) -> Iterator:
        for batch in self.source:
            yield self.fn(batch)

    def close(self):
        if hasattr(self.source, "close"):
            self.source.close()


def _crop_flip(img: np.ndarray, oh: int, ow: int, ys, xs,
               do_flip) -> np.ndarray:
    """Per-sample crop and optional horizontal flip, written once."""
    b = img.shape[0]
    out = np.empty((b, oh, ow, img.shape[3]), img.dtype)
    for i in range(b):
        v = img[i, ys[i]:ys[i] + oh, xs[i]:xs[i] + ow]
        out[i] = v[:, ::-1] if do_flip[i] else v
    return out


def image_transform(train: bool, seed: int = 0, crop_pad: int = 4,
                    flip: bool = True, dtype=np.float32,
                    out_hw: Optional[tuple] = None) -> Callable:
    """Stored uint8 images -> model-input batches; labels pass through.
    Training adds a random crop and a horizontal flip, in one of two
    geometries:

    * ``out_hw`` None (CIFAR): pad by ``crop_pad``, then crop back to the
      stored size;
    * ``out_hw`` smaller than the stored size (ImageNet's oversized
      records): a random ``out_hw`` window, or its center in eval.

    A floating ``dtype`` converts uint8 to [0, 1) on the host; uint8 leaves
    the images for the model to normalise on the device."""
    rng = np.random.default_rng((seed, 0xA46))
    out_dtype = np.dtype(dtype)

    def fn(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        img = batch["image"]
        b, h, w = img.shape[:3]
        oh, ow = out_hw if out_hw is not None else (h, w)
        if oh > h or ow > w:
            raise ValueError(
                f"stored images {h}x{w} smaller than requested "
                f"crop {oh}x{ow}")
        do_flip = (rng.random(b) < 0.5 if train and flip
                   else np.zeros(b, bool))
        if (oh, ow) != (h, w):
            if train:
                ys = rng.integers(0, h - oh + 1, b)
                xs = rng.integers(0, w - ow + 1, b)
            else:
                ys = np.full(b, (h - oh) // 2)
                xs = np.full(b, (w - ow) // 2)
            img = _crop_flip(img, oh, ow, ys, xs, do_flip)
        elif train and crop_pad > 0:
            img = np.pad(
                img, ((0, 0), (crop_pad, crop_pad), (crop_pad, crop_pad),
                      (0, 0)))
            ys = rng.integers(0, 2 * crop_pad + 1, b)
            xs = rng.integers(0, 2 * crop_pad + 1, b)
            img = _crop_flip(img, oh, ow, ys, xs, do_flip)
        elif do_flip.any():
            img = _crop_flip(img, oh, ow, np.zeros(b, int), np.zeros(b, int),
                             do_flip)
        if np.issubdtype(out_dtype, np.floating):
            if img.dtype == np.uint8:
                img = np.multiply(img, out_dtype.type(1.0 / 255.0),
                                  dtype=out_dtype)
            else:
                img = img.astype(out_dtype, copy=False)
        elif img.dtype != out_dtype:
            raise ValueError(
                f"stored dtype {img.dtype} cannot bridge to non-float "
                f"model input {out_dtype} host-side")
        out = dict(batch)
        out["image"] = np.ascontiguousarray(img)
        return out

    return fn


def mlm_transform(vocab_size: int, mask_rate: float = 0.15, seed: int = 0,
                  mask_token: int = MASK_ID, pad_id: int = 0) -> Callable:
    """{"input_ids"} -> a BERT-style batch masked anew each call: each
    non-pad position is selected with probability ``mask_rate`` (a pad
    never is); of the selected, 80 % become [MASK], 10 % a random token and
    10 % stay. ``attn_mask`` marks the non-pad positions, and rows must be
    suffix-padded (the models read the mask's row sums as lengths): interior
    padding raises."""
    rng = np.random.default_rng((seed, 0xB3A7))

    def fn(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        ids = batch["input_ids"].astype(np.int32)
        attn = (ids != pad_id).astype(np.int32)
        if not (attn[:, :-1] >= attn[:, 1:]).all():
            raise ValueError(
                "input_ids contain interior padding; the MLM pipeline "
                "requires suffix-padded rows (valid prefix, padded tail)")
        sel = (rng.random(ids.shape) < mask_rate) & (attn == 1)
        roll = rng.random(ids.shape)
        corrupted = np.where(roll < 0.8, mask_token,
                             np.where(roll < 0.9,
                                      rng.integers(0, vocab_size, ids.shape),
                                      ids)).astype(np.int32)
        tokens = np.where(sel, corrupted, ids)
        return {"tokens": tokens, "labels": ids,
                "mlm_mask": sel.astype(np.int32), "attn_mask": attn}

    return fn


def lm_transform() -> Callable:
    def fn(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"tokens": batch["input_ids"].astype(np.int32)}

    return fn


def auto_transform(meta_fields, input_spec, task: str, train: bool,
                   seed: int = 0, augment: bool = False,
                   mask_rate: float = 0.15,
                   vocab_size: Optional[int] = None) -> Optional[Callable]:
    """The shard-schema -> model-input bridge, or None when the dataset's
    batches are the model's inputs already (a published synthetic
    dataset). ``input_spec`` is the bundle's {field: Spec}; ``train`` with
    ``augment`` crops and flips images (eval sources never augment)."""
    names = {f.name for f in meta_fields}
    want = set(input_spec)
    if names == want:
        if "image" in names:
            field = next(f for f in meta_fields if f.name == "image")
            spec_dtype = str(np.dtype(input_spec["image"].dtype))
            spec_hw = tuple(input_spec["image"].shape[1:3])
            out_hw = spec_hw if tuple(field.shape[:2]) != spec_hw else None
            if field.dtype != spec_dtype or out_hw or (train and augment):
                return image_transform(train=train and augment, seed=seed,
                                       dtype=np.dtype(spec_dtype),
                                       out_hw=out_hw)
        return None
    if names == {"input_ids"}:
        if task == "mlm":
            if vocab_size is None:
                raise ValueError("mlm transform needs the model vocab size")
            return mlm_transform(vocab_size, mask_rate=mask_rate, seed=seed)
        if task == "lm":
            return lm_transform()
    raise ValueError(
        f"dataset fields {sorted(names)} do not match the model's expected "
        f"inputs {sorted(want)} and no transform bridges them")
