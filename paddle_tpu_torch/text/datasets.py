"""Text datasets (counterpart: paddle_tpu/text/datasets.py): Imdb,
Imikolov, Movielens, UCIHousing, Conll05st, WMT14 and WMT16.

Host numpy, as the JAX package's.  Without ``data_file`` each dataset is
the JAX package's deterministic synthetic corpus, drawn from the same
crc32-seeded ``np.random.RandomState``, so every sample equals its
sample bit for bit; with ``data_file`` (and Conll05st's dictionaries) the
reference's archive format is parsed.  Nothing is downloaded.  The
datasets pickle, for a DataLoader's spawned workers.
"""
from __future__ import annotations

import gzip
import os
import tarfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "Movielens", "UCIHousing", "Conll05st",
           "WMT14", "WMT16"]


def _rng(name: str, mode: str):
    """A numpy RandomState keyed by (name, mode) through crc32 (not
    ``hash()``, which differs between processes, so that every worker and
    rank draws one corpus)."""
    import zlib

    return np.random.RandomState(
        zlib.crc32(f"{name}:{mode}".encode()) % (2 ** 31))


class Imdb(Dataset):
    """Sentiment classification: (word-id sequence, 0/1 label).
    Reference `text/datasets/imdb.py` (aclImdb tar archive)."""

    def __init__(self, data_file: Optional[str] = None, mode="train",
                 cutoff=150, num_samples=512, vocab_size=2000, seq_len=64):
        assert mode in ("train", "test")
        self.mode = mode
        if data_file:
            self._load_archive(data_file, mode, cutoff)
        else:
            r = _rng("imdb", mode)
            self.word_idx = {f"w{i}": i for i in range(vocab_size)}
            n = num_samples
            self.docs = [r.randint(0, vocab_size, (r.randint(8, seq_len),))
                         .astype(np.int64) for _ in range(n)]
            self.labels = [int(l) for l in r.randint(0, 2, (n,))]

    def _load_archive(self, path, mode, cutoff):
        # aclImdb format: tar with {train,test}/{pos,neg}/*.txt
        import re

        pat = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        freq: Dict[str, int] = {}
        raw: List[Tuple[List[str], int]] = []
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                g = pat.match(m.name)
                if not g:
                    continue
                words = tf.extractfile(m).read().decode(
                    "utf-8", "ignore").lower().split()
                raw.append((words, 1 if g.group(1) == "pos" else 0))
                for w in words:
                    freq[w] = freq.get(w, 0) + 1
        vocab = [w for w, c in sorted(freq.items(), key=lambda kv: -kv[1])
                 if c > cutoff]
        self.word_idx = {w: i for i, w in enumerate(vocab)}
        unk = len(self.word_idx)
        self.docs = [np.asarray([self.word_idx.get(w, unk) for w in ws],
                                np.int64) for ws, _ in raw]
        self.labels = [l for _, l in raw]

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i], np.asarray(self.labels[i], np.int64)


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset: tuples of n word ids.
    Reference `text/datasets/imikolov.py`."""

    def __init__(self, data_file: Optional[str] = None, data_type="NGRAM",
                 window_size=5, mode="train", min_word_freq=50,
                 num_samples=1024, vocab_size=1000):
        assert data_type in ("NGRAM", "SEQ")
        self.data_type = data_type
        self.window_size = window_size
        if data_file:
            self._load_archive(data_file, mode, min_word_freq)
        else:
            r = _rng("imikolov", mode)
            self.word_idx = {f"w{i}": i for i in range(vocab_size)}
            if data_type == "NGRAM":
                self.data = [tuple(r.randint(0, vocab_size, (window_size,))
                                   .astype(np.int64))
                             for _ in range(num_samples)]
            else:
                self.data = [r.randint(0, vocab_size,
                                       (r.randint(4, 20),)).astype(np.int64)
                             for _ in range(num_samples)]

    def _load_archive(self, path, mode, min_word_freq):
        fn = f"./simple-examples/data/ptb.{ 'train' if mode == 'train' else 'valid' }.txt"
        freq: Dict[str, int] = {}
        lines = []
        with tarfile.open(path) as tf:
            with tf.extractfile(fn) as f:
                for line in f.read().decode().splitlines():
                    ws = line.strip().split()
                    lines.append(ws)
                    for w in ws:
                        freq[w] = freq.get(w, 0) + 1
        vocab = [w for w, c in freq.items() if c >= min_word_freq]
        self.word_idx = {w: i for i, w in enumerate(sorted(vocab))}
        unk = len(self.word_idx)
        self.data = []
        for ws in lines:
            ids = [self.word_idx.get(w, unk) for w in ws]
            if self.data_type == "NGRAM":
                for i in range(len(ids) - self.window_size + 1):
                    self.data.append(tuple(
                        np.asarray(x, np.int64)
                        for x in ids[i: i + self.window_size]))
            else:
                self.data.append(np.asarray(ids, np.int64))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class Movielens(Dataset):
    """Rating prediction: (user feats..., movie feats..., score).
    Reference `text/datasets/movielens.py` (ml-1m archive)."""

    AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]

    def __init__(self, data_file: Optional[str] = None, mode="train",
                 test_ratio=0.1, rand_seed=0, num_samples=2048,
                 num_users=500, num_movies=300):
        if data_file is not None:
            self._load_archive(data_file, mode.lower(), test_ratio,
                               rand_seed)
            return
        r = _rng("movielens", mode)
        self.num_users = num_users
        self.num_movies = num_movies
        n = num_samples
        self.samples = []
        # same schema as the archive path (and the reference): shape-(1,)
        # scalar features and score = rating*2-5.  Ratings come from a
        # latent-factor model so the corpus is learnable (real preference
        # data has structure; pure noise would make the book recommender
        # example meaningless).
        u_lat = r.randn(num_users, 4)
        m_lat = r.randn(num_movies, 4)
        for _ in range(n):
            user_id = r.randint(0, num_users)
            gender = r.randint(0, 2)
            age = r.randint(0, 7)
            job = r.randint(0, 21)
            movie_id = r.randint(0, num_movies)
            categories = r.randint(0, 2, (18,)).astype(np.int64)
            title = r.randint(0, 5000, (8,)).astype(np.int64)
            affinity = float(u_lat[user_id] @ m_lat[movie_id])
            rating = int(np.clip(round(3 + affinity), 1, 5))
            score = float(rating) * 2 - 5.0
            self.samples.append((
                np.array([user_id], np.int64), np.array([gender], np.int64),
                np.array([age], np.int64), np.array([job], np.int64),
                np.array([movie_id], np.int64), categories, title,
                np.array([score], np.float32)))

    def _load_archive(self, data_file, mode, test_ratio, rand_seed):
        """Parse the real ml-1m zip (reference
        `text/datasets/movielens.py:157-213`): movies.dat / users.dat
        metadata then ratings.dat rows split train/test by rand_seed, each
        sample = ([uid],[gender],[age idx],[job]) + ([mov id],[category
        ids],[title word ids]) + [[rating*2-5]]."""
        import re
        import zipfile

        pattern = re.compile(r"^(.*)\((\d+)\)$")
        movie_info, user_info = {}, {}
        # ids assigned in file-encounter order: deterministic across
        # processes/runs (hash-seeded set iteration would give each DP rank
        # a different vocabulary)
        self.movie_title_dict = {}
        self.categories_dict = {}
        with zipfile.ZipFile(data_file) as pkg:
            with pkg.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, cats = line.decode("latin1").strip() \
                        .split("::")
                    cats = cats.split("|")
                    for c in cats:
                        self.categories_dict.setdefault(
                            c, len(self.categories_dict))
                    m = pattern.match(title)
                    title = m.group(1) if m else title
                    movie_info[int(mid)] = (int(mid), cats, title)
                    for w in title.split():
                        self.movie_title_dict.setdefault(
                            w.lower(), len(self.movie_title_dict))
            with pkg.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _ = line.decode("latin1") \
                        .strip().split("::")
                    user_info[int(uid)] = (
                        int(uid), 0 if gender == "M" else 1,
                        self.AGE_TABLE.index(int(age)), int(job))
            rnd = np.random.RandomState(rand_seed)
            is_test = mode == "test"
            self.samples = []
            with pkg.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rnd.random_sample() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ = line.decode("latin1").strip() \
                        .split("::")
                    u = user_info[int(uid)]
                    mid_i, cats, title = movie_info[int(mid)]
                    self.samples.append((
                        np.array([u[0]], np.int64),
                        np.array([u[1]], np.int64),
                        np.array([u[2]], np.int64),
                        np.array([u[3]], np.int64),
                        np.array([mid_i], np.int64),
                        np.array([self.categories_dict[c] for c in cats],
                                 np.int64),
                        np.array([self.movie_title_dict[w.lower()]
                                  for w in title.split()], np.int64),
                        np.array([float(rating) * 2 - 5.0], np.float32)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class UCIHousing(Dataset):
    """Boston housing regression: (13 features, 1 target).
    Reference `text/datasets/uci_housing.py`."""

    FEATURE_DIM = 13

    def __init__(self, data_file: Optional[str] = None, mode="train"):
        if data_file:
            raw = np.loadtxt(data_file)
        else:
            r = _rng("uci_housing", "all")
            w = r.randn(self.FEATURE_DIM)
            x = r.randn(506, self.FEATURE_DIM)
            y = x @ w + 0.1 * r.randn(506)
            raw = np.concatenate([x, y[:, None]], axis=1)
        # normalize features (the reference ships feature-scaled data)
        feats = raw[:, :-1]
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
        raw = np.concatenate([feats, raw[:, -1:]], axis=1)
        split = int(len(raw) * 0.8)
        self.data = raw[:split] if mode == "train" else raw[split:]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        row = self.data[i].astype(np.float32)
        return row[:-1], row[-1:]


class Conll05st(Dataset):
    """SRL dataset: (word_ids, ctx_n2/n1/0/p1/p2, verb_ids, mark, labels).
    Reference `text/datasets/conll05.py`.

    With ``data_file`` (+ the three dictionary files) the REAL CoNLL-2005
    archive format is parsed: a tar containing
    ``conll05st-release/test.wsj/words/test.wsj.words.gz`` (one token per
    line, blank line between sentences) and
    ``.../props/test.wsj.props.gz`` (per-token columns: predicate lemma or
    '-', then one bracketed SRL tag column per predicate).  Each
    (sentence, predicate) pair becomes one sample with the B-/I-/O tag
    expansion and the +-2 verb context windows the reference emits.
    Without files, a deterministic synthetic corpus is generated."""

    UNK_IDX = 0

    def __init__(self, data_file: Optional[str] = None,
                 word_dict_file: Optional[str] = None,
                 verb_dict_file: Optional[str] = None,
                 target_dict_file: Optional[str] = None, mode="train",
                 num_samples=256, vocab_size=5000, num_labels=67,
                 seq_len=24):
        if data_file is not None:
            missing = [n for n, f in [("word_dict_file", word_dict_file),
                                      ("verb_dict_file", verb_dict_file),
                                      ("target_dict_file",
                                       target_dict_file)] if f is None]
            if missing:
                raise ValueError(
                    f"Conll05st with data_file also needs {missing}")
            self.word_dict = self._load_dict(word_dict_file)
            self.predicate_dict = self._load_dict(verb_dict_file)
            self.label_dict = self._load_label_dict(target_dict_file)
            self.samples = self._parse_archive(data_file)
            return
        r = _rng("conll05", mode)
        self.samples = []
        for _ in range(num_samples):
            n = r.randint(5, seq_len)
            words = r.randint(0, vocab_size, (n,)).astype(np.int64)
            ctxs = [r.randint(0, vocab_size, (n,)).astype(np.int64)
                    for _ in range(5)]
            verb = np.full((n,), r.randint(0, vocab_size), np.int64)
            mark = r.randint(0, 2, (n,)).astype(np.int64)
            labels = r.randint(0, num_labels, (n,)).astype(np.int64)
            self.samples.append((words, *ctxs, verb, mark, labels))

    # -- archive parsing (reference conll05.py formats) ---------------------
    @staticmethod
    def _load_dict(filename):
        with open(filename, "r") as f:
            return {line.strip(): i for i, line in enumerate(f)}

    @staticmethod
    def _load_label_dict(filename):
        """targetDict.txt: B-/I- tag names; ids are (B, I) pairs per tag
        in sorted order, then 'O' last (the reference iterates a set —
        sorted here for determinism across runs)."""
        tags = set()
        with open(filename, "r") as f:
            for line in f:
                line = line.strip()
                if line.startswith(("B-", "I-")):
                    tags.add(line[2:])
        d = {}
        for i, tag in enumerate(sorted(tags)):
            d["B-" + tag] = 2 * i
            d["I-" + tag] = 2 * i + 1
        d["O"] = 2 * len(tags)
        return d

    def _parse_archive(self, data_file):
        import gzip
        import tarfile

        with tarfile.open(data_file) as tf:
            base = "conll05st-release/test.wsj"
            wf = tf.extractfile(f"{base}/words/test.wsj.words.gz")
            pf = tf.extractfile(f"{base}/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words_f, \
                    gzip.GzipFile(fileobj=pf) as props_f:
                word_lines = [ln.decode().strip() for ln in words_f]
                prop_lines = [ln.decode().strip().split()
                              for ln in props_f]
        samples = []
        sent: List[str] = []
        rows: List[List[str]] = []
        for word, row in zip(word_lines + [""], prop_lines + [[]]):
            if row:
                sent.append(word)
                rows.append(row)
                continue
            if sent:
                # column 0: predicate lemmas ('-' elsewhere); columns
                # 1..: one bracketed tag sequence per predicate
                verbs = [r[0] for r in rows if r[0] != "-"]
                n_preds = len(rows[0]) - 1
                for p in range(n_preds):
                    tags = self._expand_tags([r[p + 1] for r in rows])
                    samples.append(
                        self._make_sample(sent, verbs[p], tags))
            sent, rows = [], []
        return samples

    @staticmethod
    def _expand_tags(col):
        """Bracketed props column -> B-/I-/O sequence (the reference's
        in-bracket state machine)."""
        out = []
        cur, inside = "O", False
        for tok in col:
            if tok == "*":
                out.append("I-" + cur if inside else "O")
            elif tok == "*)":
                out.append("I-" + cur)
                inside = False
            elif "(" in tok and ")" in tok:
                cur = tok[1:tok.find("*")]
                out.append("B-" + cur)
                inside = False
            elif "(" in tok:
                cur = tok[1:tok.find("*")]
                out.append("B-" + cur)
                inside = True
            else:
                raise RuntimeError(f"unexpected SRL tag {tok!r}")
        return out

    def _make_sample(self, sentence, predicate, labels):
        n = len(sentence)
        v = labels.index("B-V")
        mark = [0] * n
        ctx = {}
        for off, key, pad in ((-2, "n2", "bos"), (-1, "n1", "bos"),
                              (0, "0", None), (1, "p1", "eos"),
                              (2, "p2", "eos")):
            j = v + off
            if 0 <= j < n:
                mark[j] = 1
                ctx[key] = sentence[j]
            else:
                ctx[key] = pad
        wd, UNK = self.word_dict, self.UNK_IDX
        word_idx = np.array([wd.get(w, UNK) for w in sentence], np.int64)
        ctxs = [np.full((n,), wd.get(ctx[k], UNK), np.int64)
                for k in ("n2", "n1", "0", "p1", "p2")]
        pred = np.full((n,), self.predicate_dict.get(predicate, 0),
                       np.int64)
        lab = np.array([self.label_dict[w] for w in labels], np.int64)
        return (word_idx, *ctxs, pred,
                np.array(mark, np.int64), lab)

    def get_dict(self):
        """reference `Conll05st.get_dict`."""
        return self.word_dict, self.predicate_dict, self.label_dict

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class _WMTBase(Dataset):
    """(source ids, target ids, target-next ids) translation triples."""

    BOS, EOS, UNK = 0, 1, 2
    START_MARK, END_MARK, UNK_MARK = "<s>", "<e>", "<unk>"

    def __init__(self, name, mode, dict_size, num_samples, seq_len):
        r = _rng(name, mode)
        dict_size = max(dict_size, 16)
        self.src_dict = {f"s{i}": i for i in range(dict_size)}
        self.trg_dict = {f"t{i}": i for i in range(dict_size)}
        self.samples = []
        for _ in range(num_samples):
            ns = r.randint(3, seq_len)
            nt = r.randint(3, seq_len)
            src = r.randint(3, dict_size, (ns,)).astype(np.int64)
            trg_body = r.randint(3, dict_size, (nt,)).astype(np.int64)
            trg = np.concatenate([[self.BOS], trg_body]).astype(np.int64)
            trg_next = np.concatenate([trg_body, [self.EOS]]).astype(np.int64)
            self.samples.append((src, trg, trg_next))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class WMT14(_WMTBase):
    """reference `text/datasets/wmt14.py`."""

    def __init__(self, data_file: Optional[str] = None, mode="train",
                 dict_size=1000, num_samples=512, seq_len=20):
        if data_file is not None:
            self._load_archive(data_file, mode.lower(), dict_size)
            return
        super().__init__("wmt14", mode, dict_size, num_samples, seq_len)

    def _load_archive(self, data_file, mode, dict_size):
        """Parse the real wmt14 tgz (reference `wmt14.py:108-161`):
        *src.dict / *trg.dict members give the vocabularies (first
        `dict_size` lines), the `{mode}/{mode}` member holds tab-separated
        src/trg sentence pairs; pairs longer than 80 tokens are dropped."""
        import tarfile

        def to_dict(fd, size):
            out = {}
            for i, line in enumerate(fd):
                if i >= size:
                    break
                out[line.decode("utf-8").strip()] = i
            return out

        with tarfile.open(data_file, mode="r") as f:
            members = f.getmembers()
            src_name = [m for m in members if m.name.endswith("src.dict")]
            trg_name = [m for m in members if m.name.endswith("trg.dict")]
            assert len(src_name) == 1 and len(trg_name) == 1
            self.src_dict = to_dict(f.extractfile(src_name[0]), dict_size)
            self.trg_dict = to_dict(f.extractfile(trg_name[0]), dict_size)
            suffix = "{}/{}".format(mode, mode)
            self.samples = []
            for m in members:
                if not m.name.endswith(suffix):
                    continue
                for line in f.extractfile(m):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, self.UNK) for w in
                           [self.START_MARK] + parts[0].split()
                           + [self.END_MARK]]
                    trg = [self.trg_dict.get(w, self.UNK)
                           for w in parts[1].split()]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    trg_next = trg + [self.trg_dict[self.END_MARK]]
                    trg = [self.trg_dict[self.START_MARK]] + trg
                    self.samples.append(
                        (np.asarray(src, np.int64),
                         np.asarray(trg, np.int64),
                         np.asarray(trg_next, np.int64)))


class WMT16(_WMTBase):
    """reference `text/datasets/wmt16.py`."""

    def __init__(self, data_file: Optional[str] = None, mode="train",
                 src_lang_dict_size=1000, trg_lang_dict_size=1000,
                 lang="en", num_samples=512, seq_len=20):
        if data_file is not None:
            self._load_archive(data_file, mode.lower(), lang,
                               src_lang_dict_size, trg_lang_dict_size)
            return
        super().__init__("wmt16", mode,
                         max(src_lang_dict_size, trg_lang_dict_size),
                         num_samples, seq_len)

    def _load_archive(self, data_file, mode, lang, src_size, trg_size):
        """Parse the real wmt16 tgz (reference `wmt16.py:159-215`): vocab
        built from the `wmt16/train` member per language (marks first, then
        words by frequency), data from `wmt16/{mode}` tab-separated en/de
        pairs with `lang` choosing the source column."""
        import tarfile
        from collections import defaultdict

        src_col = 0 if lang == "en" else 1
        with tarfile.open(data_file, mode="r") as f:
            # one pass over wmt16/train fills BOTH frequency tables (a
            # gzip tar re-decompresses the member on every extractfile)
            freq = (defaultdict(int), defaultdict(int))
            for line in f.extractfile("wmt16/train"):
                parts = line.decode("utf-8").strip().split("\t")
                if len(parts) != 2:
                    continue
                for col in (0, 1):
                    for w in parts[col].split():
                        freq[col][w] += 1

            def to_dict(col, size):
                words = [self.START_MARK, self.END_MARK, self.UNK_MARK]
                words += [w for w, _ in sorted(freq[col].items(),
                                               key=lambda x: x[1],
                                               reverse=True)
                          ][:max(0, size - 3)]
                return {w: i for i, w in enumerate(words)}

            self.src_dict = to_dict(src_col, src_size)
            self.trg_dict = to_dict(1 - src_col, trg_size)
            self.samples = []
            for line in f.extractfile("wmt16/{}".format(mode)):
                parts = line.decode("utf-8").strip().split("\t")
                if len(parts) != 2:
                    continue
                src = [self.BOS] + [self.src_dict.get(w, self.UNK)
                                    for w in parts[src_col].split()] \
                    + [self.EOS]
                trg = [self.trg_dict.get(w, self.UNK)
                       for w in parts[1 - src_col].split()]
                trg_next = trg + [self.EOS]
                trg = [self.BOS] + trg
                self.samples.append((np.asarray(src, np.int64),
                                     np.asarray(trg, np.int64),
                                     np.asarray(trg_next, np.int64)))
