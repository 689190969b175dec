"""The importer's TF32 guard (``importer._ieee_float32``) under threads.

The flags it sets are process-global, and the batched executor runs graphs
on its own dispatch thread, one an executor. Two threads interleave the
guard through events: the second enters while the first is inside, the
first leaves while the second is still inside. Both flags must stay False
for the whole of the second's run, and the caller's values must come back
after the last one leaves. On the CPU torch lets the flags be set and
read, so the race shows deterministically.
"""
import threading

import pytest
import torch

from synapseml_tpu_torch.onnx.importer import _ieee_float32

WAIT = 10.0


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set_flags(cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@pytest.mark.parametrize("caller", [(True, True), (True, False),
                                    (False, True), (False, False)])
def test_flags_stay_off_while_any_thread_runs_and_come_back(caller):
    saved = _flags()
    a_inside, b_inside, a_left = (threading.Event() for _ in range(3))
    seen, errors = [], []

    def run_a():
        try:
            with _ieee_float32():
                a_inside.set()
                if not b_inside.wait(WAIT):
                    raise TimeoutError("b never entered")
                seen.append(("a", _flags()))
            a_left.set()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            a_left.set()

    def run_b():
        try:
            if not a_inside.wait(WAIT):
                raise TimeoutError("a never entered")
            with _ieee_float32():
                seen.append(("b_entered", _flags()))
                b_inside.set()
                if not a_left.wait(WAIT):
                    raise TimeoutError("a never left")
                # a has left: b's remaining float32 work must still run
                # with TF32 off
                seen.append(("b_after_a_left", _flags()))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            b_inside.set()

    try:
        _set_flags(*caller)
        threads = [threading.Thread(target=run_a),
                   threading.Thread(target=run_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT * 3)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert dict(seen) == {"a": (False, False),
                              "b_entered": (False, False),
                              "b_after_a_left": (False, False)}
        assert _flags() == caller
    finally:
        _set_flags(*saved)


def test_nested_and_sequential_runs_restore_the_callers_flags():
    saved = _flags()
    try:
        _set_flags(True, False)
        with _ieee_float32():
            with _ieee_float32():
                assert _flags() == (False, False)
            assert _flags() == (False, False)
        assert _flags() == (True, False)
        with pytest.raises(ValueError):
            with _ieee_float32():
                raise ValueError("a failing run")
        assert _flags() == (True, False)
    finally:
        _set_flags(*saved)
