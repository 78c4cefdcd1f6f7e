"""Host-side batch transforms between the shard stream and the device,
the port of the language-model part of ``serverless_learn_tpu/data/
transforms.py``: :class:`TransformedSource`, :func:`lm_transform`
(``{"input_ids"}`` -> ``{"tokens"}``) and :func:`auto_transform`, which
picks the bridge from a dataset's fields and the model's inputs.

The image transform (decode, crop, flip) and dynamic MLM masking wait
with the models that read them (ROADMAP.md queue 1): ``auto_transform``
raises where the reference would pick one of them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from serverless_learn_tpu_torch.config import not_ported

_WAITS = "ROADMAP.md queue 1 item 5"


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


def lm_transform() -> Callable:
    def fn(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"tokens": batch["input_ids"].astype(np.int32)}

    return fn


def auto_transform(meta_fields, input_names: Iterable[str],
                   task: str) -> Optional[Callable]:
    """The shard-schema -> model-input bridge, or None when the dataset's
    fields are the model's inputs already (a published synthetic
    dataset). ``input_names`` are the model's input fields."""
    names = {f.name for f in meta_fields}
    want = set(input_names)
    if names == want:
        if "image" in names:
            raise not_ported("the image transform (decode, crop, flip)",
                             _WAITS)
        return None
    if names == {"input_ids"}:
        if task == "lm":
            return lm_transform()
        if task == "mlm":
            raise not_ported("dynamic MLM masking", _WAITS)
    raise ValueError(
        f"dataset fields {sorted(names)} do not match the model's expected "
        f"inputs {sorted(want)} and no transform bridges them")
