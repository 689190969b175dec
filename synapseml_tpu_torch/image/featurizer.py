"""ImageFeaturizer: transfer learning via a headless imported network.

The counterpart of the reference package's ``image/featurizer.py`` (itself
the rebuild of ref: deep-learning/src/main/scala/com/microsoft/ml/spark/
cntk/ImageFeaturizer.scala:40-197 — resize -> unroll -> truncated network
via ``cutOutputLayers``:100; headless featurization or full predictions,
image or binary input column).

The backbone is an imported ONNX graph (any user ``.onnx`` file or a
:mod:`synapseml_tpu_torch.onnx.zoo` constructor): ``cut_output_layers``
drops the last N graph nodes (``ImportedGraph.truncated``). Images are
resized on the featurizer's device one at a time on the host side of the
pipeline, then normalised on the card, cast to bf16 where asked, run
through ``ImportedGraph.apply`` on the weights bound once to the device,
and flattened — all inside the
:class:`~synapseml_tpu_torch.runtime.executor.BatchedExecutor`'s function,
so staging of mini-batch k+1 overlaps the card's work on k.
:meth:`ImageFeaturizer.warmup` captures each bucket as a CUDA graph.

``devices=`` runs each mini-batch bucket data-parallel over a device list
(the executor's shard and round-robin layouts); images are resized on the
first entry's device.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.core.param import (ComplexParam, HasInputCol,
                                            HasOutputCol, Param)
from synapseml_tpu_torch.core.pipeline import Transformer
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.image import ops
from synapseml_tpu_torch.image.reader import decode_image
from synapseml_tpu_torch.onnx.importer import ImportedGraph, import_model
from synapseml_tpu_torch.runtime import compile_cache as _cc
from synapseml_tpu_torch.runtime.executor import (BatchedExecutor,
                                                  resolve_devices)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol):
    """Featurize an image column through a truncated deep network.

    ``cut_output_layers=0`` returns the model's full output (predictions);
    ``>=1`` removes that many trailing graph nodes and returns the last
    surviving activation, flattened — the transfer-learning feature vector
    (reference semantics, ImageFeaturizer.scala:100 cutOutputLayers).
    ``transform(table, device="cuda")`` runs on the card and raises
    without CUDA; ``device="cpu"`` runs the same path on the CPU.
    """

    model_payload = ComplexParam("raw .onnx backbone bytes")
    cut_output_layers = Param("trailing graph nodes to drop", default=1)
    image_size = Param("square input side fed to the net", default=224)
    mean = Param("per-channel normalization mean (0-1 scale)",
                 default=(0.485, 0.456, 0.406))
    std = Param("per-channel normalization std", default=(0.229, 0.224, 0.225))
    channels = Param("backbone input channels (3, or 1 for grayscale "
                     "nets like the bundled digits-cnn)", default=3)
    compute_dtype = Param("float32|bfloat16", default="float32")
    mini_batch_size = Param("max rows per device batch", default=64)
    devices = Param(
        "data-parallel device spec: None, 'all', int N (the first N CUDA "
        "devices), or a device sequence (entries may repeat: each is a "
        "slot) — buckets are sharded or run round robin by the executor",
        default=None)
    compile_cache_dir = Param(
        "directory of the executable store warmup() records each bucket's "
        "warm program in (default: the SYNAPSEML_COMPILE_CACHE env var)",
        default=None)

    def __init__(self, model_path: Optional[str] = None,
                 model_bytes: Optional[bytes] = None, **kw):
        super().__init__(**kw)
        if model_path is not None:
            with open(model_path, "rb") as fh:
                model_bytes = fh.read()
        if model_bytes is not None:
            self.set(model_payload=bytes(model_bytes))

    def _post_copy(self, src):
        super()._post_copy(src)
        self.__dict__.pop("_feat_cache", None)

    def _load_extra(self, path: str):
        self.__dict__.pop("_feat_cache", None)

    def _pieces(self, device) -> BatchedExecutor:
        dev = device_policy.resolve(device)
        devs = resolve_devices(self.devices)
        if devs is not None and any(d.type != dev.type for d in devs):
            raise ValueError(
                f"devices={self.devices!r} name {[str(d) for d in devs]}, "
                f"but this call runs on {dev.type!r}")
        cache = self.__dict__.get("_feat_cache")
        key = (self.cut_output_layers, self.compute_dtype,
               self.mini_batch_size, tuple(self.mean), tuple(self.std),
               self.channels, hash(self.model_payload), dev, devs,
               self.compile_cache_dir)
        if cache is not None and cache[0] == key:
            return cache[1]
        graph: ImportedGraph = import_model(self.model_payload)
        if self.cut_output_layers > 0:
            graph = graph.truncated(self.cut_output_layers)
        compute = _DTYPES[self.compute_dtype]
        params = {}
        for k, v in graph.params.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            params[k] = t.to(compute) if t.is_floating_point() else t
        c = int(self.channels)

        def per_channel(vals, what):
            if len(vals) == c:
                return list(vals)
            if len(vals) == 1:  # scalar stat tiles across channels
                return list(vals) * c
            # no silent truncation: the default ImageNet 3-tuple applied
            # to a channels=1 net would quietly normalize with the RED
            # channel's stats — make the user choose
            raise ValueError(
                f"{what} has {len(vals)} entries but channels={c}; "
                f"provide one value per channel (or a single scalar)")

        mean, std = (torch.tensor(per_channel(v, what), dtype=torch.float32
                                  ).reshape(1, -1, 1, 1)
                     for v, what in ((self.mean, "mean"), (self.std, "std")))

        def fn(p, mean, std, imgs_nchw):
            x = (imgs_nchw.to(torch.float32) / 255.0 - mean) / std
            (out,) = graph.apply(p, x.to(compute))
            return out.reshape(out.shape[0], -1).to(torch.float32)

        # content hash over backbone bytes + featurization config: a
        # changed model or a different cut/normalization must miss
        cache_key = _cc.content_hash(
            self.model_payload, self.cut_output_layers, self.compute_dtype,
            tuple(self.mean), tuple(self.std), c)
        executor = BatchedExecutor(fn, device=None if devs else dev,
                                   devices=devs,
                                   max_bucket=self.mini_batch_size,
                                   bound_args=(params, mean, std),
                                   cache_key=cache_key,
                                   cache_dir=self.compile_cache_dir)
        self.__dict__["_feat_cache"] = (key, executor)
        return executor

    def warmup(self, buckets=None, device=device_policy.DEFAULT_DEVICE):
        """Capture every mini-batch bucket of the NCHW float32 featurization
        signature as a CUDA graph (on the CPU, warm the eager function)
        before traffic, recording each in the executable store when a
        compile-cache dir is configured — see
        :meth:`synapseml_tpu_torch.runtime.executor.BatchedExecutor.warmup`."""
        size = int(self.image_size)
        row = (int(self.channels), size, size)
        return self._pieces(device).warmup([(row, np.float32)],
                                           buckets=buckets)

    def _prepare(self, v: Any, dev: torch.device) -> Optional[np.ndarray]:
        """Anything image-ish -> [size, size, channels] float32 HWC."""
        if v is None:
            return None
        if isinstance(v, (bytes, bytearray)):
            v = decode_image(bytes(v))
            if v is None:
                return None
        arr = np.asarray(v, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        c = int(self.channels)
        if arr.shape[-1] == 1 and c == 3:
            arr = np.repeat(arr, 3, axis=-1)
        elif arr.shape[-1] == 3 and c == 1:
            # BT.601 luma on the host (RGB weights matching
            # ops.color_format COLOR_RGB2GRAY)
            arr = arr[..., :3] @ np.array([0.299, 0.587, 0.114], np.float32)
            arr = arr[..., None]
        size = self.image_size
        if arr.shape[0] != size or arr.shape[1] != size:
            arr = ops.resize(torch.from_numpy(arr).to(dev), height=size,
                             width=size).cpu().numpy()
        return arr

    def _transform(self, table: Table, device) -> Table:
        executor = self._pieces(device)
        dev = executor.device
        col = table[self.input_col]
        mbs = max(1, int(self.mini_batch_size))
        valid: list = []

        def chunks():
            # lazy prepare: executor.stream pulls this generator with
            # pipeline_depth chunks in flight, so decode/resize of chunk
            # k+1 runs on the host WHILE chunk k computes on the card
            buf: list = []
            for i, v in enumerate(col):
                arr = self._prepare(v, dev)
                if arr is None:
                    continue
                valid.append(i)
                buf.append(arr)
                if len(buf) >= mbs:
                    yield (np.stack(buf).transpose(0, 3, 1, 2),)
                    buf = []
            if buf:
                yield (np.stack(buf).transpose(0, 3, 1, 2),)

        feat_chunks = [out for (out,) in executor.stream(chunks())]
        if not valid:
            return table.with_column(
                self.output_col, np.empty(table.num_rows, dtype=object))
        feats = np.asarray(
            feat_chunks[0] if len(feat_chunks) == 1
            else np.concatenate(feat_chunks), np.float32)
        if len(valid) == table.num_rows:
            return table.with_column(self.output_col, feats)
        out = np.empty(table.num_rows, dtype=object)
        for j, i in enumerate(valid):
            out[i] = feats[j]
        return table.with_column(self.output_col, out)
