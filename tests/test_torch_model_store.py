"""The port's pretrained-weight store (``mxnet_tpu_torch.models.model_store``,
``get_model(pretrained=True)``) and ``gluon.utils`` against the JAX
package's on the CPU.

- both packages read one store layout (``<root>/models/<name>.params``):
  a file the reference publishes loads into the port bit for bit, and a
  file the port publishes loads into the reference bit for bit;
- a ``file://`` ``MXNET_GLUON_REPO`` mirror fills an empty store (the
  download sha1-checked against the published digest);
- a store copy whose sha1 differs from the registered one, a mirror
  file whose sha1 differs, and a missing model raise the reference's
  errors with the reference's texts;
- ``split_data``, ``split_and_load``, ``clip_global_norm``,
  ``check_sha1`` and ``download`` as the reference's (exact, fp32 sums:
  ``CLIP_TOL`` of the norm)."""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.gluon import utils as jutils  # noqa: E402
from mxnet_tpu.models import model_store as jstore  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch.gluon import utils as tutils  # noqa: E402
from mxnet_tpu_torch.models import model_store as tstore  # noqa: E402

torch.set_num_threads(1)

NAME = "lenet"
ITEM = (28, 28, 1)
CLIP_TOL = 1e-6     # of the norm: fp32 sums of squares in another order


@pytest.fixture(autouse=True)
def _clean_registries(monkeypatch):
    """Each test starts with no registered digests and no repository."""
    monkeypatch.setattr(jstore, "_model_sha1", {})
    monkeypatch.setattr(tstore, "_model_sha1", {})
    monkeypatch.delenv("MXNET_GLUON_REPO", raising=False)
    monkeypatch.delenv("MXNET_TPU_REPO", raising=False)


def _saved_lenet(path, seed=0):
    """A seeded port LeNet after its deferred-shape forward, saved to
    ``path`` → its parameters as numpy."""
    net = tmodels.get_model(NAME)
    net.initialize(ctx="cpu", seed=seed)
    with torch.no_grad():
        net(torch.zeros((1,) + ITEM))
    net.save_parameters(str(path))
    return {k: t.detach().numpy().copy()
            for k, t in net.collect_params().items()}


def _port_params(net):
    return {k: t.detach().numpy() for k, t in net.collect_params().items()}


def _ref_params(net):
    return {k: np.asarray(p.data()._data)
            for k, p in net.collect_params().items()}


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_reference_publish_port_loads_bit_for_bit(tmp_path):
    want = _saved_lenet(tmp_path / "w.params")
    root = str(tmp_path / "store")
    dst = jstore.publish_model_file(NAME, str(tmp_path / "w.params"),
                                    root=root)
    assert dst == os.path.join(root, "models", f"{NAME}.params")
    # the reference's digest, registered in the port: the port checks it
    tstore.register_model_sha1(NAME, jstore._model_sha1[NAME])
    assert tstore.short_hash(NAME) == jstore.short_hash(NAME)
    assert tstore.get_model_file(NAME, root=root) == dst
    net = tmodels.get_model(NAME, pretrained=True, root=root)
    _same(_port_params(net), want)
    with torch.no_grad():
        out = net(torch.ones((2,) + ITEM))
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def test_port_publish_reference_loads_bit_for_bit(tmp_path):
    want = _saved_lenet(tmp_path / "w.params", seed=3)
    root = str(tmp_path / "store")
    dst = tstore.publish_model_file(NAME, str(tmp_path / "w.params"),
                                    root=root)
    assert dst == os.path.join(root, "models", f"{NAME}.params")
    with open(dst, "rb") as f, open(tmp_path / "w.params", "rb") as g:
        assert f.read() == g.read()
    jstore.register_model_sha1(NAME, tstore._model_sha1[NAME])
    jnet = jmodels.get_model(NAME, pretrained=True, root=root)
    _same(_ref_params(jnet), want)


def test_file_mirror_fills_an_empty_store(tmp_path, monkeypatch):
    want = _saved_lenet(tmp_path / "w.params", seed=5)
    mirror, root = str(tmp_path / "mirror"), str(tmp_path / "store")
    tstore.publish_model_file(NAME, str(tmp_path / "w.params"),
                              root=mirror)
    sha = tstore._model_sha1[NAME]
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://" + mirror)
    assert tstore.repo_url() == jstore.repo_url() == "file://" + mirror
    path = tstore.get_model_file(NAME, root=root)
    assert path == os.path.join(root, "models", f"{NAME}.params")
    assert tutils.check_sha1(path, sha)
    _same(_port_params(tmodels.get_model(NAME, pretrained=True,
                                         root=root)), want)
    # the reference downloads the same bytes into its own empty store
    jstore.register_model_sha1(NAME, sha)
    jroot = str(tmp_path / "jstore")
    jpath = jstore.get_model_file(NAME, root=jroot)
    with open(jpath, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()
    # purge empties the store; the next resolve downloads again
    tstore.purge(root=root)
    assert not os.path.exists(os.path.join(root, "models"))
    assert tstore.get_model_file(NAME, root=root) == path


def test_bad_sha1_raises_the_reference_errors(tmp_path, monkeypatch):
    _saved_lenet(tmp_path / "w.params")
    root = str(tmp_path / "store")
    tstore.publish_model_file(NAME, str(tmp_path / "w.params"), root=root)
    jstore.register_model_sha1(NAME, "0" * 40)
    tstore.register_model_sha1(NAME, "0" * 40)
    with pytest.raises(OSError) as jerr:
        jstore.get_model_file(NAME, root=root)
    with pytest.raises(OSError) as terr:
        tstore.get_model_file(NAME, root=root)
    assert str(terr.value) == str(jerr.value)
    assert "sha1 does not match" in str(terr.value)
    # a mirror whose file has another digest: every attempt refused
    mirror = str(tmp_path / "mirror")
    shutil.copytree(os.path.join(root, "models"),
                    os.path.join(mirror, "models"))
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://" + mirror)
    for store, mod in ((str(tmp_path / "t"), tstore),
                       (str(tmp_path / "j"), jstore)):
        with pytest.raises(RuntimeError, match="failed after 5 attempts"):
            mod.get_model_file(NAME, root=store)
        assert os.listdir(os.path.join(store, "models")) == []


def test_missing_model_raises_the_reference_error(tmp_path):
    root = str(tmp_path / "none")
    with pytest.raises(FileNotFoundError) as jerr:
        jstore.get_model_file(NAME, root=root)
    with pytest.raises(FileNotFoundError) as terr:
        tmodels.get_model(NAME, pretrained=True, root=root)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        tstore.short_hash(NAME)


def test_default_home_is_the_reference_store(monkeypatch, tmp_path):
    monkeypatch.delenv("MXNET_TPU_HOME", raising=False)
    assert tstore.data_dir() == jstore.data_dir() == os.path.join(
        os.path.expanduser("~"), ".mxnet_tpu")
    monkeypatch.setenv("MXNET_TPU_HOME", str(tmp_path))
    assert tstore.data_dir() == jstore.data_dir() == str(tmp_path)


# ------------------------------------------------------------ gluon.utils
@pytest.mark.parametrize("n,slices,even", [(8, 4, True), (10, 3, False),
                                           (6, 1, True)])
def test_split_data_matches_reference(n, slices, even):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got = tutils.split_data(torch.from_numpy(x), slices, even_split=even)
    want = jutils.split_data(mx.np.array(x), slices, even_split=even)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w._data))
    with pytest.raises(ValueError):
        tutils.split_data(torch.zeros(10, 2), 3)


def test_split_and_load_places_each_slice():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    parts = tutils.split_and_load(x, ["cpu", "cpu", "cpu"])
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 3
    assert all(p.device.type == "cpu" for p in parts)
    assert np.array_equal(torch.cat(parts).numpy(), x)
    one = tutils.split_and_load(torch.from_numpy(x), ["cpu"])
    assert len(one) == 1 and np.array_equal(one[0].numpy(), x)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_reference(max_norm):
    rs = np.random.RandomState(0)
    arrays = [rs.randn(4, 5).astype(np.float32),
              rs.randn(7).astype(np.float32)]
    t = [torch.from_numpy(a.copy()) for a in arrays]
    j = [mx.np.array(a) for a in arrays]
    got = tutils.clip_global_norm(t, max_norm)
    want = jutils.clip_global_norm(j, max_norm)
    assert abs(got - want) <= CLIP_TOL * want
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._data),
                                   rtol=CLIP_TOL, atol=CLIP_TOL * got)
    with pytest.warns(UserWarning):
        tutils.clip_global_norm([torch.tensor([np.inf])], 1.0)


def test_download_and_check_sha1(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(os.urandom(3000))
    import hashlib
    sha = hashlib.sha1(src.read_bytes()).hexdigest()
    assert tutils.check_sha1(str(src), sha) == jutils.check_sha1(
        str(src), sha) is True
    assert tutils.check_sha1(str(src), sha[:8])
    assert not tutils.check_sha1(str(src), "f" * 40)
    out = tutils.download("file://" + str(src), path=str(tmp_path / "d"),
                          sha1_hash=sha)
    assert open(out, "rb").read() == src.read_bytes()
    # a directory path takes the URL's name; an existing good file stays
    os.makedirs(tmp_path / "dir")
    out2 = tutils.download("file://" + str(src), path=str(tmp_path / "dir"))
    assert out2 == str(tmp_path / "dir" / "blob.bin")
    assert tutils.download("file://" + str(tmp_path / "missing"),
                           path=out2) == out2
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        tutils.download("file://" + str(tmp_path / "missing"),
                        path=str(tmp_path / "x"), retries=2)
    assert not [f for f in os.listdir(tmp_path) if ".part." in f]
