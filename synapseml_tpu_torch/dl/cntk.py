"""CNTKModel: CNTK-lineage model inference on the port.

The counterpart of the reference package's ``dl/cntk.py``. CNTK's native
runtime is not used: raw CNTK v2 ``.model`` bytes are parsed directly (the
protobuf Dictionary format, :mod:`synapseml_tpu_torch.dl.cntk_format`),
converted to ONNX, and scored through the port's importer and
:class:`~synapseml_tpu_torch.onnx.model.ONNXModel` (the batched executor,
``warmup()``'s CUDA graphs). A recurrence (PastValue/FutureValue) arrives
as an ONNX ``Scan``. CNTK's own ONNX export is accepted as it is. The
reference CNTKModel's API is kept: inputs and outputs by node name or
index, ``cut_output_layers``, minibatching. ``transform`` runs on the card
unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

from typing import Optional, Union

from synapseml_tpu_torch.core.param import Param
from synapseml_tpu_torch.onnx.model import ONNXModel


_NATIVE_CNTK_MSG = (
    "this CNTK .model file could not be parsed: the direct reader covers "
    "CNTK v2 feedforward graphs (dl/cntk_format.py); v1/BrainScript-era "
    "binaries and recurrent v2 graphs need a one-time ONNX export with "
    "the CNTK python package — z.save('model.onnx', "
    "format=cntk.ModelFormat.ONNX) — load that file here instead")


def _coerce_payload(payload: bytes) -> bytes:
    """ONNX bytes pass through; CNTK v2 Dictionary bytes convert via the
    direct reader (dl/cntk_format.py); anything else (v1 binaries,
    unsupported graphs) raises with the export recipe."""
    if _looks_like_onnx(payload):
        return payload
    from synapseml_tpu_torch.dl.cntk_format import cntk_to_onnx, sniff_cntk_v2

    parsed = sniff_cntk_v2(payload)  # one decode, reused for conversion
    if parsed is not None:
        try:
            return cntk_to_onnx(payload, parsed=parsed)
        except (NotImplementedError, KeyError, ValueError, TypeError) as e:
            # the class contract is "raises ValueError with the export
            # recipe" — malformed composites must not leak bare KeyErrors
            raise ValueError(f"{_NATIVE_CNTK_MSG} (reader said: {e})") \
                from e
    raise ValueError(_NATIVE_CNTK_MSG)


def _looks_like_onnx(payload: bytes) -> bool:
    # Both ONNX ModelProto and CNTK v2 Dictionary bytes open with a
    # field-1 varint, so magic sniffing is not enough — but a FULL decode
    # just to sniff would parse every weight tensor. Instead, skim the
    # TOP-LEVEL wire fields only: ModelProto has graph at field 7 /
    # opset_import at 8; the Dictionary has nothing above field 2.
    # Sub-messages are skipped, not decoded.
    head = payload[:64]
    if b"C\x00N\x00T\x00K" in head or head.startswith(b"CNTK"):
        return False
    from synapseml_tpu_torch.onnx.proto import _read_varint, _skip

    pos, end = 0, len(payload)
    try:
        while pos < end:
            tag, pos = _read_varint(payload, pos)
            num, wire = tag >> 3, tag & 7
            if num == 0 or num > 1000:
                return False  # not a sane proto field
            if num in (7, 8) and wire == 2:  # graph / opset_import
                return True
            pos = _skip(payload, pos, wire)
        return False
    except Exception:  # noqa: BLE001 - undecodable -> not ONNX
        return False


class CNTKModel(ONNXModel):
    """Runs a CNTK-lineage network (CNTK v2 bytes or its ONNX export) as a
    transformer.

    Extends :class:`ONNXModel` with the reference CNTKModel's
    name-or-index port selection: ``set_input_node(1)`` /
    ``set_output_node("z")``, and ``cut_output_layers`` (the
    ``cut_layers`` Param, so a saved or copied model stays headless).
    """

    cut_layers = Param("trailing graph nodes dropped (headless "
                       "featurization; persists across serde)", default=0)

    def __init__(self, model_path: Optional[str] = None,
                 model_bytes: Optional[bytes] = None, **kw):
        if model_path is not None:
            with open(model_path, "rb") as fh:
                model_bytes = fh.read()
            model_path = None
        if model_bytes is not None:
            model_bytes = _coerce_payload(bytes(model_bytes))
        super().__init__(model_bytes=model_bytes, **kw)

    # -- truncation-aware graph (param-backed: survives save/load/copy) --
    @property
    def graph(self):
        cut = int(self.cut_layers or 0)
        payload = self.model_payload
        cache = self.__dict__.get("_cntk_graph")
        # `is` on the retained payload object (not id(): reuse-safe)
        if (cache is not None and cache[0] == cut
                and cache[1] is payload):
            return cache[2]
        with self._build_lock():
            # re-read under the lock: racing first calls import (and
            # cut) one graph, so their executors share one key
            payload = self.model_payload
            cache = self.__dict__.get("_cntk_graph")
            if (cache is not None and cache[0] == cut
                    and cache[1] is payload):
                return cache[2]
            if payload is not None and not _looks_like_onnx(
                    bytes(payload)):
                # covers every assignment path (model_payload=... via
                # set(), load), not just __init__ kwargs
                payload = _coerce_payload(bytes(payload))
                self.set(model_payload=payload)
            g = ONNXModel.graph.fget(self)
            if cut:
                g = g.truncated(cut)
            self.__dict__["_cntk_graph"] = (cut, payload, g)
            return g

    def _post_copy(self, src):
        super()._post_copy(src)
        self.__dict__.pop("_cntk_graph", None)

    def _load_extra(self, path: str):
        super()._load_extra(path)
        self.__dict__.pop("_cntk_graph", None)

    # -- name-or-index port selection ----------------------------------
    def _input_name(self, node: Union[int, str]) -> str:
        names = self.graph.input_names
        if isinstance(node, int):
            return names[node]
        if node not in names:
            raise KeyError(f"no input node {node!r}; have {names}")
        return node

    def _output_name(self, node: Union[int, str]) -> str:
        names = self.graph.output_names
        if isinstance(node, int):
            return names[node]
        if node not in names:
            raise KeyError(f"no output node {node!r}; have {names}")
        return node

    def set_input_node(self, node: Union[int, str],
                       column: str = "input") -> "CNTKModel":
        """Bind a table column to a graph input by name or index (merges —
        multi-input graphs chain calls)."""
        self.set(feed_dict={**(self.feed_dict or {}),
                            self._input_name(node): column})
        return self

    def set_output_node(self, node: Union[int, str],
                        column: str = "output") -> "CNTKModel":
        """Fetch one graph output by name or index (merges)."""
        self.set(fetch_dict={**(self.fetch_dict or {}),
                             column: self._output_name(node)})
        return self

    def cut_output_layers(self, n: int) -> "CNTKModel":
        """Headless featurization hook: drops the trailing ``n`` graph
        nodes. Stored as the ``cut_layers`` param so serde round-trips
        stay headless."""
        self.set(cut_layers=int(n))
        self.__dict__.pop("_cntk_graph", None)
        self.__dict__["_executor_cache"] = {}
        return self
