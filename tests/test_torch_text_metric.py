"""paddle_tpu_torch's text datasets and metrics against the JAX package's.

- **Datasets.** Every synthetic corpus (each mode and data type) is
  bit-equal to the JAX package's, sample by sample: both draw from the
  same crc32-seeded ``np.random.RandomState``.  Each archive format is
  parsed from files this test writes (aclImdb tar, PTB tar, UCI text,
  ml-1m zip, CoNLL-2005 tar of gz members with its dictionaries, wmt14
  and wmt16 tgz), and the samples and dictionaries equal the JAX
  package's.  A dataset pickles (a spawned DataLoader worker gets it so)
  and the copy gives the same samples.
- **Metrics.** Host numpy accumulators, as the JAX package's:
  ``Precision``/``Recall``/``Auc``/``accuracy`` counts and values, the
  chunk spans of every scheme, ``ChunkEvaluator``'s counts and
  precision/recall/F1, ``DetectionMAP`` (11point and integral) over
  several images, ``detection_map_update``'s states and mAP, and
  ``mean_iou`` are equal (floats bit-equal where the same numpy ran;
  ``mean_iou`` on the op library's confusion matrix within 1e-6).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import gzip
import io
import pickle
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.metric as JM
import paddle_tpu.text as JT
import paddle_tpu_torch as T
import paddle_tpu_torch.metric as TM
import paddle_tpu_torch.text as TT
from paddle_tpu_torch.core import place as TPL

from test_torch_tensor_api import _public


@pytest.fixture(autouse=True)
def on_cpu():
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("cpu")
    yield
    TPL._EXPECTED_DEVICE[0] = prev


def same_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape, i
            np.testing.assert_array_equal(u, v, err_msg=str(i))


# ---------------------------------------------------------------------------
# synthetic corpora
# ---------------------------------------------------------------------------
SYNTHETIC = {
    "imdb_train": ("Imdb", dict(mode="train")),
    "imdb_test": ("Imdb", dict(mode="test", num_samples=64, seq_len=30)),
    "imikolov_ngram": ("Imikolov", dict(window_size=4)),
    "imikolov_seq": ("Imikolov", dict(data_type="SEQ", mode="test")),
    "movielens": ("Movielens", dict(num_samples=300)),
    "uci_train": ("UCIHousing", dict(mode="train")),
    "uci_test": ("UCIHousing", dict(mode="test")),
    "conll05": ("Conll05st", dict()),
    "conll05_tagger": ("Conll05st", dict(num_labels=67, seq_len=128,
                                         num_samples=64)),
    "wmt14": ("WMT14", dict(mode="test", dict_size=100)),
    "wmt16": ("WMT16", dict(src_lang_dict_size=50, trg_lang_dict_size=80)),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_corpus_bit_equal(name):
    cls, kw = SYNTHETIC[name]
    same_samples(getattr(TT, cls)(**kw), getattr(JT, cls)(**kw))


def test_dataset_pickles_for_spawned_workers():
    ds = TT.Conll05st(num_samples=16)
    same_samples(pickle.loads(pickle.dumps(ds)), ds)
    from paddle_tpu_torch.io import DataLoader

    loader = DataLoader(TT.UCIHousing(mode="test"), batch_size=8)
    x, y = next(iter(loader))
    assert tuple(x.shape) == (8, 13) and tuple(y.shape) == (8, 1)


# ---------------------------------------------------------------------------
# archive formats, from files this test writes
# ---------------------------------------------------------------------------
def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _imdb(tmp_path):
    path = str(tmp_path / "aclImdb.tar.gz")
    docs = {"train/pos/0.txt": "good film good good", "train/neg/1.txt":
            "bad film bad", "train/pos/2.txt": "a good plot",
            "test/neg/3.txt": "bad bad plot"}
    with tarfile.open(path, "w:gz") as tar:
        for nm, text in docs.items():
            _add(tar, f"aclImdb/{nm}", text.encode())
    return path


def _ptb(tmp_path):
    path = str(tmp_path / "simple-examples.tgz")
    train = "the cat sat\nthe dog sat down\na cat ran\n"
    with tarfile.open(path, "w:gz") as tar:
        _add(tar, "./simple-examples/data/ptb.train.txt", train.encode())
        _add(tar, "./simple-examples/data/ptb.valid.txt", b"the cat\n")
    return path


def _uci(tmp_path):
    path = tmp_path / "housing.data"
    r = np.random.RandomState(1)
    np.savetxt(path, r.rand(20, 14) * 10)
    return str(path)


def _movielens(tmp_path):
    path = str(tmp_path / "ml-1m.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Heat (1995)::Action|Crime\n")
        z.writestr("ml-1m/users.dat",
                   "1::M::25::15::55117\n2::F::35::7::02460\n")
        z.writestr("ml-1m/ratings.dat", "1::1::5::978300760\n"
                   "2::2::3::978302109\n1::2::4::978301968\n"
                   "2::1::1::978302110\n")
    return path


def _conll(tmp_path):
    words = "the\ncat\nchased\nmice\n.\n\nmice\nran\n\n"
    # one predicate a sentence: one tag column after the lemmas
    props = ("-\t(A0*\n-\t*)\nchase\t(V*)\n-\t(A1*)\n-\t*\n\n"
             "-\t(A0*)\nrun\t(V*)\n\n")
    path = tmp_path / "conll05st-tests.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        for member, text in (
                ("conll05st-release/test.wsj/words/test.wsj.words.gz",
                 words),
                ("conll05st-release/test.wsj/props/test.wsj.props.gz",
                 props)):
            _add(tar, member, gzip.compress(text.encode()))
    (tmp_path / "wordDict.txt").write_text(
        "the\ncat\nchased\nmice\n.\nbos\neos\nran\n")
    (tmp_path / "verbDict.txt").write_text("chase\nrun\n")
    (tmp_path / "targetDict.txt").write_text("B-A0\nI-A0\nB-A1\nB-V\nO\n")
    return dict(data_file=str(path),
                word_dict_file=str(tmp_path / "wordDict.txt"),
                verb_dict_file=str(tmp_path / "verbDict.txt"),
                target_dict_file=str(tmp_path / "targetDict.txt"))


def _wmt14(tmp_path):
    path = str(tmp_path / "wmt14.tgz")
    with tarfile.open(path, "w:gz") as tar:
        _add(tar, "wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n")
        _add(tar, "wmt14/trg.dict", b"<s>\n<e>\n<unk>\nbonjour\nmonde\n")
        _add(tar, "wmt14/train/train",
             b"hello world\tbonjour monde\nhello\tbonjour\nbad line\n")
        _add(tar, "wmt14/test/test", b"hello\tmonde\n")
    return path


def _wmt16(tmp_path):
    path = str(tmp_path / "wmt16.tgz")
    with tarfile.open(path, "w:gz") as tar:
        _add(tar, "wmt16/train", b"a b b\tx y\nb\ty\nc a\tz x\n")
        _add(tar, "wmt16/val", b"a\tx\nb c\ty z\n")
    return path


ARCHIVES = {
    "imdb": ("Imdb", _imdb, dict(mode="train", cutoff=0)),
    "imdb_test": ("Imdb", _imdb, dict(mode="test", cutoff=0)),
    "imikolov_ngram": ("Imikolov", _ptb, dict(window_size=2,
                                              min_word_freq=1)),
    "imikolov_seq": ("Imikolov", _ptb, dict(data_type="SEQ", mode="test",
                                            min_word_freq=2)),
    "uci": ("UCIHousing", _uci, dict(mode="test")),
    "movielens": ("Movielens", _movielens, dict(test_ratio=0.3,
                                                rand_seed=1)),
    "wmt14": ("WMT14", _wmt14, dict(dict_size=5)),
    "wmt16": ("WMT16", _wmt16, dict(mode="val", src_lang_dict_size=5,
                                    trg_lang_dict_size=4, lang="de")),
}


@pytest.mark.parametrize("name", sorted(ARCHIVES))
def test_archive_parsed_as_jax(name, tmp_path):
    cls, make, kw = ARCHIVES[name]
    path = make(tmp_path)
    t = getattr(TT, cls)(data_file=path, **kw)
    j = getattr(JT, cls)(data_file=path, **kw)
    assert len(t) > 0
    same_samples(t, j)
    for attr in ("word_idx", "src_dict", "trg_dict", "categories_dict",
                 "movie_title_dict"):
        if hasattr(j, attr):
            assert getattr(t, attr) == getattr(j, attr), attr


def test_conll05_archive_parsed_as_jax(tmp_path):
    kw = _conll(tmp_path)
    t, j = TT.Conll05st(**kw), JT.Conll05st(**kw)
    assert len(t) == 2
    same_samples(t, j)
    assert t.get_dict() == j.get_dict()
    with pytest.raises(ValueError):
        TT.Conll05st(data_file=kw["data_file"])


def test_every_public_name_has_a_counterpart():
    import paddle_tpu.text.datasets as JTD
    import paddle_tpu_torch.text.datasets as TTD

    for jmod, tmod in ((JM, TM), (JT, TT), (JTD, TTD)):
        want = (_public(jmod) | set(getattr(jmod, "__all__", ()))) - {
            "Tensor", "Dataset"}
        assert want <= set(dir(tmod)), sorted(want - set(dir(tmod)))
    covered = {"Metric", "Accuracy", "Precision", "Recall", "Auc",
               "accuracy", "extract_chunk_spans", "ChunkEvaluator",
               "DetectionMAP", "mean_iou", "detection_map_update"}
    assert _public(JM) <= covered, sorted(_public(JM) - covered)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _binary(r, n):
    return r.uniform(0, 1, (n, 1)).astype(np.float32), \
        r.integers(0, 2, (n, 1)).astype(np.int64)


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_equal(cls):
    r = np.random.default_rng(0)
    jm_, tm_ = getattr(JM, cls)(), getattr(TM, cls)()
    for _ in range(3):
        p, y = _binary(r, 200)
        if cls == "Auc":
            p = np.concatenate([1 - p, p], 1)
        jm_.update(P.to_tensor(p), P.to_tensor(y))
        tm_.update(torch.from_numpy(p), torch.from_numpy(y))
    assert tm_.accumulate() == jm_.accumulate()
    assert tm_.name() == jm_.name()
    if cls == "Auc":
        np.testing.assert_array_equal(tm_._stat_pos, jm_._stat_pos)
        np.testing.assert_array_equal(tm_._stat_neg, jm_._stat_neg)
    tm_.reset()
    assert tm_.accumulate() == 0.0


def test_accuracy_function_equal():
    r = np.random.default_rng(1)
    x = r.standard_normal((16, 10)).astype(np.float32)
    y = r.integers(0, 10, (16, 1)).astype(np.int64)
    for k in (1, 3):
        want = np.asarray(JM.accuracy(P.to_tensor(x), P.to_tensor(y), k=k))
        got = TM.accuracy(torch.from_numpy(x), torch.from_numpy(y), k=k)
        np.testing.assert_array_equal(got.numpy(), want)


def _tags(r, n, types, n_tag):
    return r.integers(-1, types * n_tag + 1, n)


@pytest.mark.parametrize("scheme", ["plain", "IOB", "IOE", "IOBES"])
def test_chunk_spans_equal(scheme):
    r = np.random.default_rng(2)
    n_tag = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    for _ in range(20):
        tags = _tags(r, 30, 3, n_tag)
        for excl in ((), (1,)):
            assert TM.extract_chunk_spans(tags, scheme, 3, excl) == \
                JM.extract_chunk_spans(tags, scheme, 3, excl)


def test_chunk_evaluator_equal():
    r = np.random.default_rng(3)
    je, te = JM.ChunkEvaluator(), TM.ChunkEvaluator()
    for _ in range(3):
        inf = r.integers(0, 7, (4, 12))
        lab = np.where(r.uniform(size=(4, 12)) < 0.7, inf,
                       r.integers(0, 7, (4, 12)))
        lens = r.integers(1, 13, 4)
        jc = je.compute(P.to_tensor(inf), P.to_tensor(lab),
                        P.to_tensor(lens), n_types=3)
        tc = te.compute(torch.from_numpy(inf), torch.from_numpy(lab),
                        torch.from_numpy(lens), n_types=3)
        assert tc == jc
        je.update(*jc)
        te.update(*(torch.tensor(v) for v in tc))
    assert te.accumulate() == je.accumulate()
    assert te.extract_chunks([0, 1, 1, 2, 3], n_types=2) == \
        je.extract_chunks([0, 1, 1, 2, 3], n_types=2)


def _det_image(r, n_det, n_gt, classes):
    gxy = r.uniform(0, 0.6, (n_gt, 2))
    gt = np.concatenate([gxy, gxy + r.uniform(0.1, 0.4, (n_gt, 2))], 1)
    gl = r.integers(0, classes, n_gt)
    pick = r.integers(0, n_gt, n_det)
    pb = gt[pick] + r.normal(0, 0.05, (n_det, 4))
    ps = np.round(r.uniform(0, 1, n_det), 1)      # tied scores
    pl = np.where(r.uniform(size=n_det) < 0.8, gl[pick],
                  r.integers(0, classes, n_det))
    return [a.astype(np.float32) if a.dtype.kind == "f" else a
            for a in (pb, ps, pl, gt, gl)]


@pytest.mark.parametrize("ap", ["11point", "integral"])
def test_detection_map_equal(ap):
    r = np.random.default_rng(4)
    jd, td = JM.DetectionMAP(ap_version=ap), TM.DetectionMAP(ap_version=ap)
    for _ in range(4):
        img = _det_image(r, 12, 5, 3)
        jd.update(*img)
        td.update(*[torch.from_numpy(np.asarray(a)) for a in img])
    assert td._dets == jd._dets and td._gt_count == jd._gt_count
    assert td.accumulate() == jd.accumulate()


def test_detection_map_update_equal():
    r = np.random.default_rng(5)
    b, m, g, c, cap = 2, 6, 4, 3, 16
    det = np.zeros((b, m, 6), np.float32)
    gt = np.zeros((b, g, 6), np.float32)
    for i in range(b):
        pb, ps, pl, gb, gl = _det_image(r, m, g, c)
        det[i] = np.concatenate([pl[:, None], ps[:, None], pb], 1)
        gt[i] = np.concatenate([gl[:, None], (r.uniform(size=(g, 1))
                                              < 0.3), gb], 1)
    state = (np.zeros(c, np.int64), np.zeros((c, cap, 2), np.float32),
             np.zeros(c, np.int64), np.zeros((c, cap, 2), np.float32),
             np.zeros(c, np.int64))
    for diff in (True, False):
        args = (det, [6, 4], gt, [4, 3], state[0], state[1], state[2],
                state[3], state[4], c)
        want = JM.detection_map_update(*args, evaluate_difficult=diff)
        got = TM.detection_map_update(*args, evaluate_difficult=diff)
        for u, v in zip(got, want):
            np.testing.assert_array_equal(u, v)


def test_mean_iou_equal():
    r = np.random.default_rng(6)
    p = r.integers(0, 5, (3, 16)).astype(np.int32)
    y = r.integers(0, 5, (3, 16)).astype(np.int32)
    want = [np.asarray(v) for v in JM.mean_iou(p, y, 6)]
    got = TM.mean_iou(p, y, 6)
    for u, v in zip(got, want):
        np.testing.assert_allclose(u.numpy(), v, rtol=1e-6, atol=1e-6)
