"""The cpp-package's training examples built against the port's C API
library and run on the CPU (the examples hard-code ``Context::cpu()``):
twins of test_c_api.py's ``test_cpp_lenet_train_binary``,
``test_cpp_resnet_train_binary`` and ``test_cpp_charrnn_train_binary``, on
the same data and arguments, except that the residual network and the
character LSTM train 3 epochs (the JAX package's twins: 8 and 6; on the
port both pass 0.9 from the second) to keep this file within a minute of
one worker beside the suite's other workers.  Each example prints PASS
when its last epoch's training accuracy exceeds 0.9.
"""
import subprocess
import threading

import numpy as np
import pytest

from mxnet_tpu_torch.ops.kernel_build import HostLibrary
from test_torch_threads import child_env
from test_torch_threads import torch_threads_per_worker  # noqa: F401

EXAMPLES = ("lenet_train", "resnet_train", "charrnn_train")


@pytest.fixture(scope="module")
def binaries():
    """The three examples, built at once (one g++ each, in threads)."""
    host = HostLibrary()
    host.op_h()
    out, errors = {}, []

    def build(name):
        try:
            out[name] = host.example(name)
        except Exception as exc:   # reported below
            errors.append(exc)
    threads = [threading.Thread(target=build, args=(n,)) for n in EXAMPLES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors
    return host, out


def _images(tmp_path):
    rng = np.random.RandomState(0)
    n, h = 256, 12
    y = rng.randint(0, 2, n)
    x = rng.randn(n, 1, h, h).astype(np.float32) * 0.4
    x[y == 1, 0, 3:9, 3:9] += 1.5
    data_csv, label_csv = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(data_csv, x.reshape(n, -1), delimiter=",", fmt="%.5f")
    np.savetxt(label_csv, y.astype(np.float32), delimiter=",", fmt="%g")
    return str(data_csv), str(label_csv)


def _run(binaries, name, args):
    host, built = binaries
    res = subprocess.run([built[name]] + args, capture_output=True,
                         text=True, env=host.run_env(child_env()),
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "PASS" in res.stdout
    return res.stdout


def test_cpp_lenet_train_binary(binaries, tmp_path):
    """DataIter (CSVIter), the Xavier initializer, the Accuracy metric and
    SGDOptimizer train LeNet through the port's library."""
    out = _run(binaries, "lenet_train",
               list(_images(tmp_path)) + ["32", "8"])
    assert out.count("accuracy") == 8


def test_cpp_resnet_train_binary(binaries, tmp_path):
    """A residual network with BatchNorm aux states (op.h BatchNorm,
    operator+ junctions, a projection shortcut, global pooling)."""
    out = _run(binaries, "resnet_train",
               list(_images(tmp_path)) + ["32", "3"])
    assert out.count("accuracy") == 3


def test_cpp_charrnn_train_binary(binaries, tmp_path):
    """A character LSTM: Embedding, the fused RNN op, SwapAxis/Reshape,
    the hidden and cell states as executor inputs without gradients."""
    rs = np.random.RandomState(0)
    pattern = np.array([3, 7, 1, 9, 4, 2, 8, 5])
    n, seq = 256, 16
    xs, ys = [], []
    for _ in range(n):
        phase = rs.randint(0, len(pattern))
        ids = pattern[(phase + np.arange(seq + 1)) % len(pattern)]
        xs.append(ids[:seq])
        ys.append(ids[1:])
    data_csv, label_csv = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(data_csv, np.array(xs, np.float32), delimiter=",", fmt="%g")
    np.savetxt(label_csv, np.array(ys, np.float32), delimiter=",", fmt="%g")
    out = _run(binaries, "charrnn_train",
               [str(data_csv), str(label_csv), "16", "3"])
    assert out.count("accuracy") == 3
