"""Natural-split federated datasets: the TFF h5 and LEAF json readers,
the seeded StackOverflow-shaped stand-in, and the poisoned sets
(``fedml_tpu.data.natural``, numpy, copied).

- TFF HDF5 (FederatedEMNIST, fed_cifar100, fed_shakespeare,
  stackoverflow): one h5 file a split, group
  ``examples/<client_id>/<field>``; h5py is imported by the reader.
- LEAF json (femnist, shakespeare, synthetic): ``{"users": [...],
  "user_data": {uid: {"x": ..., "y": ...}}}`` under ``train/`` and
  ``test/``.
- Edge-case and backdoor sets: a pixel trigger with a label flip on the
  attacker clients' samples, or an out-of-distribution pool mixed in,
  and the targeted task's evaluation.

Every reader returns :class:`FederatedData` with the natural client
split kept (``train_idx_map`` in client order), bitwise the JAX
package's on the same files. A missing file raises
``FileNotFoundError`` naming it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.data.partition import partition_indices_test


def _natural_maps(client_arrays):
    """Concatenate per-client arrays into global arrays + index maps."""
    xs, ys, idx_map = [], [], {}
    offset = 0
    for i, (x, y) in enumerate(client_arrays):
        xs.append(x)
        ys.append(y)
        idx_map[i] = np.arange(offset, offset + len(x))
        offset += len(x)
    return np.concatenate(xs), np.concatenate(ys), idx_map


def load_tff_h5_pairs(path: str, x_field: str, y_field: str):
    """Iterate (client_id, x, y) from a TFF-format h5 file."""
    import h5py

    with h5py.File(path, "r") as f:
        ex = f["examples"]
        for cid in ex.keys():
            g = ex[cid]
            yield cid, np.asarray(g[x_field]), np.asarray(g[y_field])


def load_federated_emnist(
    data_dir: str, num_classes: int = 62, task: str = "classification"
) -> FederatedData:
    """FederatedEMNIST natural split (reference
    ``FederatedEMNIST/data_loader.py``: h5 files
    ``fed_emnist_train.h5`` / ``fed_emnist_test.h5``, fields
    pixels/label)."""
    train_p = os.path.join(data_dir, "fed_emnist_train.h5")
    test_p = os.path.join(data_dir, "fed_emnist_test.h5")
    _require(train_p, "fake_femnist")
    train, test = [], []
    for _, x, y in load_tff_h5_pairs(train_p, "pixels", "label"):
        train.append((x[..., None].astype(np.float32), y.astype(np.int32)))
    for _, x, y in load_tff_h5_pairs(test_p, "pixels", "label"):
        test.append((x[..., None].astype(np.float32), y.astype(np.int32)))
    x_tr, y_tr, tr_map = _natural_maps(train)
    x_te, y_te, _ = _natural_maps(test)
    te_map = partition_indices_test(y_te, num_classes, len(tr_map))
    return FederatedData(
        x_tr, y_tr, x_te, y_te, tr_map, te_map, num_classes, task
    )


def load_fed_cifar100(data_dir: str) -> FederatedData:
    """fed_cifar100 (Pachinko natural split; reference
    ``fed_cifar100/data_loader.py``: h5 fields image/label)."""
    train_p = os.path.join(data_dir, "fed_cifar100_train.h5")
    test_p = os.path.join(data_dir, "fed_cifar100_test.h5")
    _require(train_p, "fake_fed_cifar100")
    train, test = [], []
    for _, x, y in load_tff_h5_pairs(train_p, "image", "label"):
        train.append(
            (x.astype(np.float32) / 255.0, y.astype(np.int32))
        )
    for _, x, y in load_tff_h5_pairs(test_p, "image", "label"):
        test.append((x.astype(np.float32) / 255.0, y.astype(np.int32)))
    x_tr, y_tr, tr_map = _natural_maps(train)
    x_te, y_te, _ = _natural_maps(test)
    te_map = partition_indices_test(y_te, 100, len(tr_map))
    return FederatedData(x_tr, y_tr, x_te, y_te, tr_map, te_map, 100)


def load_leaf_json(
    data_dir: str,
    num_classes: int,
    task: str = "classification",
    x_shape: tuple | None = None,
    offline_hint: str | None = None,
    text: bool = False,
) -> FederatedData:
    """LEAF json splits (reference femnist/shakespeare download scripts):
    ``train/*.json`` + ``test/*.json`` with users/user_data.
    ``offline_hint`` names a fake dataset substitute for the error message
    (only femnist has an offline stand-in). ``text=True`` reads the LEAF
    *text* format (shakespeare: x = 80-char context strings, y = next
    char) and tokenizes with the shared char vocabulary."""

    def read_split(split):
        out = {}
        d = os.path.join(data_dir, split)
        _require(d, offline_hint)
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(d, fn)) as f:
                blob = json.load(f)
            for uid in blob["users"]:
                ud = blob["user_data"][uid]
                if text:
                    out[uid] = _leaf_text_to_arrays(ud["x"], ud["y"])
                    continue
                x = np.asarray(ud["x"], np.float32)
                if x_shape is not None:
                    x = x.reshape((-1,) + tuple(x_shape))
                out[uid] = (x, np.asarray(ud["y"], np.int32))
        return out

    train = read_split("train")
    test = read_split("test")
    uids = sorted(train.keys())
    x_tr, y_tr, tr_map = _natural_maps([train[u] for u in uids])
    # users absent from the test split (LEAF --by-user) get empty slices
    # whose shapes/dtypes MATCH the train arrays (text y is [n, L] int32,
    # not a 1-D label vector)
    empty = (
        np.zeros((0,) + x_tr.shape[1:], x_tr.dtype),
        np.zeros((0,) + y_tr.shape[1:], y_tr.dtype),
    )
    x_te, y_te, te_map = _natural_maps(
        [test.get(u, empty) for u in uids]
    )
    return FederatedData(
        x_tr, y_tr, x_te, y_te, tr_map, te_map, num_classes, task
    )


def _fedprox_synthetic_full(alpha: float, beta: float, num_users: int = 30):
    """Regenerate the FULL FedProx ``synthetic(alpha, beta)`` dataset
    bit-exactly (reference ``data/synthetic_1_1/generate_synthetic.py``:
    ``np.random.seed(0)`` drives every draw, so the samples are a pure
    function of (alpha, beta)). Returns per-user ``(x [n,60] f64,
    y [n] i32)`` in generation order. Uses a legacy ``RandomState(0)``
    deliberately — it draws the same stream as the generator's
    ``np.random.seed(0)`` without clobbering the caller's global numpy
    RNG state (``default_rng`` draws a different stream and would NOT
    reproduce the shipped json files)."""
    dimension, num_class = 60, 10
    rs = np.random.RandomState(0)
    samples_per_user = rs.lognormal(4, 2, num_users).astype(int) + 50
    mean_w = rs.normal(0, alpha, num_users)
    b_prior = rs.normal(0, beta, num_users)
    cov_x = np.diag(np.arange(1, dimension + 1, dtype=np.float64) ** -1.2)
    mean_x = np.zeros((num_users, dimension))
    for i in range(num_users):
        mean_x[i] = rs.normal(b_prior[i], 1, dimension)
    out = []
    for i in range(num_users):
        w = rs.normal(mean_w[i], 1, (dimension, num_class))
        b = rs.normal(mean_w[i], 1, num_class)
        xx = rs.multivariate_normal(
            mean_x[i], cov_x, int(samples_per_user[i])
        )
        # the reference labels via argmax(softmax(logits)); softmax is
        # monotonic so argmax(logits) gives identical labels without the
        # exp (which can overflow for alpha/beta >= 1 logit scales)
        yy = np.argmax(xx @ w + b, axis=-1).astype(np.int32)
        out.append((xx, yy))
    return out


def load_synthetic_leaf(
    data_dir: str, alpha: float | None, beta: float | None
) -> FederatedData:
    """The REAL LEAF ``synthetic(alpha, beta)`` files (reference
    ``data/synthetic_*/``; benchmark row ``benchmark/README.md:14``).

    The reference checkout ships only ``test/mytest.json`` (the 10%
    split; ``train/mytrain.json`` is a stripped large blob, listed in
    ``.MISSING_LARGE_BLOBS``). The generator is fully seeded, so the
    train split is recovered exactly: regenerate the full dataset with
    the seeded procedure, then remove each user's REAL test rows by row
    match — the remainder is precisely the content of the missing
    ``mytrain.json``. Matching tolerates 1-ulp drift (the shipped files
    were generated under a different LAPACK, whose
    ``multivariate_normal`` SVD differs in the last bit on ~3% of
    entries): a rounded-key lookup first, then a nearest-row fallback
    bounded at 1e-9 max-abs — far below the ~0.1+ spacing of distinct
    gaussian rows, so a fallback match is unambiguous. When a real
    ``train/mytrain.json`` IS present it is used directly."""
    test_p = os.path.join(data_dir, "test", "mytest.json")
    train_p = os.path.join(data_dir, "train", "mytrain.json")
    _require(test_p, "synthetic")
    with open(test_p) as f:
        test_blob = json.load(f)
    uids = test_blob["users"]
    if os.path.exists(train_p):
        with open(train_p) as f:
            train_blob = json.load(f)
        train = [
            (
                np.asarray(train_blob["user_data"][u]["x"], np.float64),
                np.asarray(train_blob["user_data"][u]["y"], np.int32),
            )
            for u in uids
        ]
    else:
        if alpha is None or beta is None:
            raise ValueError(
                f"{data_dir}: train/mytrain.json is absent, so the train "
                "split must be reconstructed from the seeded generator — "
                "that needs (alpha, beta), which could not be parsed "
                "from the directory name (expected synthetic_<a>_<b>)"
            )
        full = _fedprox_synthetic_full(alpha, beta, len(uids))
        train = []
        for i, u in enumerate(uids):
            fx, fy = full[i]
            tx = np.asarray(test_blob["user_data"][u]["x"], np.float64)
            # multiset row match: every real test row must be found in
            # the regenerated user data, else the files are not the
            # seeded generation we assume — fail loudly, never guess
            pool: dict[bytes, list[int]] = {}
            for j, row in enumerate(fx):
                pool.setdefault(np.round(row, 8).tobytes(), []).append(j)
            held_out: set[int] = set()
            for row in tx:
                cands = pool.get(np.round(row, 8).tobytes())
                while cands:  # skip indices claimed via the fallback
                    if cands[-1] not in held_out:
                        break
                    cands.pop()
                if cands:
                    held_out.add(cands.pop())
                    continue
                # 1-ulp drift across a rounding boundary: nearest row
                err = np.abs(fx - row).max(axis=1)
                err[list(held_out)] = np.inf
                j = int(err.argmin())
                if err[j] > 1e-9:
                    raise ValueError(
                        f"{test_p}: user {u} test row not found in the "
                        "seeded regeneration (nearest max-abs diff "
                        f"{err[j]:.3g}) — files do not match the "
                        "FedProx generator output"
                    )
                held_out.add(j)
            keep = np.array(
                [j for j in range(len(fx)) if j not in held_out], np.int64
            )
            train.append((fx[keep], fy[keep]))
    test = [
        (
            np.asarray(test_blob["user_data"][u]["x"], np.float64),
            np.asarray(test_blob["user_data"][u]["y"], np.int32),
        )
        for u in uids
    ]
    x_tr, y_tr, tr_map = _natural_maps(
        [(x.astype(np.float32), y) for x, y in train]
    )
    x_te, y_te, te_map = _natural_maps(
        [(x.astype(np.float32), y) for x, y in test]
    )
    return FederatedData(x_tr, y_tr, x_te, y_te, tr_map, te_map, 10)


def _leaf_text_to_arrays(xs: list, ys: list):
    """LEAF shakespeare text rows -> (tokens [n, L], next-char [n, L])
    shifted LM targets: the context window is tokenized with the shared
    char vocabulary (reference ``models/shakespeare`` LEAF pipeline:
    80-char context x, single next char y — we emit full shifted targets,
    whose last column IS the LEAF y)."""
    char_id, oov = SHAKESPEARE_CHAR_ID, SHAKESPEARE_OOV

    def tok(s):
        return [char_id.get(c, oov) for c in s]

    x = np.asarray([tok(s) for s in xs], np.int32)
    y_last = np.asarray(
        [char_id.get(c[0] if c else " ", oov) for c in ys], np.int32
    )
    # shifted targets: y[:, :-1] = x[:, 1:], y[:, -1] = LEAF's next char
    y = np.concatenate([x[:, 1:], y_last[:, None]], axis=1)
    return x, y


def _require(path: str, fake_name: str | None):
    if not os.path.exists(path):
        hint = (
            f", or use dataset='{fake_name}' for offline runs"
            if fake_name
            else ""
        )
        raise FileNotFoundError(
            f"{path} not found. Download it with the reference's data "
            f"scripts{hint}."
        )


# ---------------------------------------------------------------------------
# Backdoor / edge-case poisoning (fedavg_robust evaluation)
# ---------------------------------------------------------------------------


def add_pixel_trigger(x: np.ndarray, size: int = 3) -> np.ndarray:
    """Stamp a bright square trigger in the bottom-right corner."""
    x = x.copy()
    x[..., -size:, -size:, :] = x.max()
    return x


def make_backdoor_dataset(
    data: FederatedData,
    target_label: int = 0,
    poison_fraction: float = 0.5,
    attacker_clients: tuple[int, ...] = (0,),
    trigger_size: int = 3,
    seed: int = 0,
) -> tuple[FederatedData, np.ndarray, np.ndarray]:
    """Inject a pixel-pattern backdoor into the attacker clients' samples
    (the offline analog of the reference's edge-case poisoned sets,
    ``edge_case_examples/data_loader.py``). Returns
    ``(poisoned_data, trigger_test_x, trigger_test_y)`` where the trigger
    test set measures the TARGETED task (reference poisoned-task ``test``,
    ``fedavg_robust/FedAvgRobustAggregator.py:14-64``)."""
    rng = np.random.default_rng(seed)
    x = data.x_train.copy()
    y = data.y_train.copy()
    for c in attacker_clients:
        idx = data.train_idx_map[c]
        n_poison = int(len(idx) * poison_fraction)
        if n_poison == 0:  # tiny client / small fraction: nothing to stamp
            continue
        chosen = rng.choice(idx, n_poison, replace=False)
        x[chosen] = add_pixel_trigger(x[chosen], trigger_size)
        y[chosen] = target_label
    poisoned = FederatedData(
        x, y, data.x_test, data.y_test, data.train_idx_map,
        data.test_idx_map, data.num_classes, data.task,
    )
    # targeted-task eval: every test image with the trigger should NOT be
    # classified as target_label by a clean model
    trig_x = add_pixel_trigger(data.x_test, trigger_size)
    trig_y = np.full(len(trig_x), target_label, np.int32)
    return poisoned, trig_x, trig_y


def backdoor_success_rate(model, variables, trig_x, trig_y) -> float:
    """Fraction of triggered inputs classified as the attacker's target,
    by a port model (a :class:`~fedml_tpu_torch.models.base.FedModel`) on
    its variables' device."""
    import torch

    dev = next(iter(variables.values())).device
    with torch.no_grad():
        logits = model.apply_eval(variables, torch.as_tensor(
            np.asarray(trig_x, np.float32)).to(dev))
    pred = logits.argmax(-1).cpu().numpy()
    return float(np.mean(pred == trig_y))


# ---------------------------------------------------------------------------
# TFF text datasets: fed_shakespeare + stackoverflow (nwp / lr)
# ---------------------------------------------------------------------------

# Character vocabulary from the TFF text-generation tutorial, used verbatim
# by the reference (``fed_shakespeare/utils.py`` CHAR_VOCAB). Token ids:
# 0 = pad, 1..86 = chars, 87 = bos, 88 = eos, 89 = oov.
SHAKESPEARE_CHARS = list(
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:"
    "\naeimquyAEIMQUY]!%)-159\r"
)
SHAKESPEARE_VOCAB_SIZE = len(SHAKESPEARE_CHARS) + 4  # pad + bos + eos + oov
SHAKESPEARE_SEQ_LEN = 80
# token id layout shared by every shakespeare tokenizer in this module:
# 0 = pad, 1..86 = chars, 87 = bos, 88 = eos, 89 = oov
SHAKESPEARE_CHAR_ID = {c: i + 1 for i, c in enumerate(SHAKESPEARE_CHARS)}
SHAKESPEARE_BOS = len(SHAKESPEARE_CHARS) + 1
SHAKESPEARE_EOS = len(SHAKESPEARE_CHARS) + 2
SHAKESPEARE_OOV = len(SHAKESPEARE_CHARS) + 3


def shakespeare_to_sequences(
    snippets: list[str], seq_len: int = SHAKESPEARE_SEQ_LEN
) -> np.ndarray:
    """Tokenize snippets exactly like the reference
    (``fed_shakespeare/utils.py:preprocess``): per snippet,
    ``[bos] + chars + [eos]``, zero-padded to a multiple of ``seq_len+1``,
    then chopped into ``[seq_len+1]`` windows. Returns ``[n, seq_len+1]``
    int32 (callers split into x = [:, :-1] / y = [:, 1:])."""
    char_id = SHAKESPEARE_CHAR_ID
    bos, eos, oov = SHAKESPEARE_BOS, SHAKESPEARE_EOS, SHAKESPEARE_OOV
    seqs = []
    for sn in snippets:
        tokens = [bos] + [char_id.get(c, oov) for c in sn] + [eos]
        pad = (-len(tokens)) % (seq_len + 1)
        tokens += [0] * pad
        for i in range(0, len(tokens), seq_len + 1):
            seqs.append(tokens[i : i + seq_len + 1])
    if not seqs:
        return np.zeros((0, seq_len + 1), np.int32)
    return np.asarray(seqs, np.int32)


def _build_text_federated(
    train_p: str,
    test_p: str,
    read_client,
    num_classes: int,
    task: str,
    fake_name: str,
) -> FederatedData:
    """Shared tail of the TFF text loaders: read both h5 splits with
    ``read_client`` (a per-client (x, y) producer over _iter_h5_text rows),
    build natural maps, and pool the test split if its client list does not
    align with train."""
    _require(train_p, fake_name)
    _require(test_p, fake_name)
    train = [read_client(rows) for _, rows in _iter_h5_text_groups(train_p)]
    test = [read_client(rows) for _, rows in _iter_h5_text_groups(test_p)]
    x_tr, y_tr, tr_map = _natural_maps(train)
    x_te, y_te, te_map = _natural_maps(test)
    if len(te_map) != len(tr_map):  # clients must align; pool test otherwise
        te_map = {i: np.arange(len(x_te)) for i in range(len(tr_map))}
    return FederatedData(
        x_tr, y_tr, x_te, y_te, tr_map, te_map, num_classes, task
    )


def _iter_h5_text_groups(path: str):
    """Iterate (client_id, {field: [decoded strings]}) from a TFF text h5."""
    import h5py

    with h5py.File(path, "r") as f:
        ex = f["examples"]
        for cid in ex.keys():
            g = ex[cid]
            yield cid, {
                field: [s.decode("utf8") for s in g[field][()]]
                for field in g.keys()
            }


def load_fed_shakespeare(
    data_dir: str, seq_len: int = SHAKESPEARE_SEQ_LEN
) -> FederatedData:
    """fed_shakespeare from the TFF h5 pair (reference
    ``fed_shakespeare/data_loader.py:27-70``: ``shakespeare_train.h5`` /
    ``shakespeare_test.h5``, group ``examples/<client_id>/snippets`` of
    utf-8 bytes). Char-LM next-character prediction: x = tokens[:, :-1],
    y = tokens[:, 1:] (reference ``utils.split``)."""
    def read_client(rows):
        seqs = shakespeare_to_sequences(rows["snippets"], seq_len)
        return seqs[:, :-1], seqs[:, 1:]

    return _build_text_federated(
        os.path.join(data_dir, "shakespeare_train.h5"),
        os.path.join(data_dir, "shakespeare_test.h5"),
        read_client,
        SHAKESPEARE_VOCAB_SIZE,
        "nwp",
        "fake_shakespeare",
    )


def _read_word_count(path: str, vocab_size: int) -> dict[str, int]:
    """Top-``vocab_size`` words from a TFF ``stackoverflow.word_count``
    file: one ``word count`` pair per line, most frequent first (reference
    ``stackoverflow_nwp/utils.py:get_most_frequent_words``)."""
    words = {}
    with open(path) as f:
        for line in f:
            w = line.split()[0]
            words[w] = len(words)
            if len(words) >= vocab_size:
                break
    return words


def stackoverflow_to_sequences(
    sentences: list[str],
    word_dict: dict[str, int],
    seq_len: int = 20,
) -> np.ndarray:
    """Tokenize like the reference (``stackoverflow_nwp/utils.py:tokenizer``):
    truncate to ``seq_len`` words, append eos if short, prepend bos, pad to
    ``seq_len+1``. Ids: 0=pad, 1..V=words, V+1=bos, V+2=eos, V+3=oov."""
    V = len(word_dict)
    bos, eos, oov = V + 1, V + 2, V + 3
    out = np.zeros((len(sentences), seq_len + 1), np.int32)
    for i, sen in enumerate(sentences):
        words = sen.split(" ")[:seq_len]
        tokens = [word_dict[w] + 1 if w in word_dict else oov for w in words]
        if len(tokens) < seq_len:
            tokens.append(eos)
        tokens = [bos] + tokens
        out[i, : len(tokens)] = tokens
    return out


def synthetic_stackoverflow_nwp(
    num_clients: int = 64,
    vocab_size: int = 10000,
    seq_len: int = 20,
    seed: int = 0,
    sentences_low: int = 16,
    sentences_high: int = 96,
) -> FederatedData:
    """Seeded StackOverflow-SHAPED next-word-prediction stand-in: the
    exact ``[B, T]`` int32 contract of :func:`load_stackoverflow_nwp`
    without the 3424-client TFF download — ids 0=pad, 1..V words,
    V+1=bos, V+2=eos, V+3=oov; every sequence starts at bos, short
    sentences close with eos then pad; x = tokens[:, :-1],
    y = tokens[:, 1:].

    Content is a sparse Markov chain over a Zipf-weighted vocabulary
    with a per-client successor bias, so the token stream is learnable
    AND naturally non-IID across clients (the property the federated
    fine-tuning benchmark exercises). Client sizes are seeded-uneven
    like the real split. Surfaced as the EXPLICIT dataset name
    ``synthetic_stackoverflow_nwp`` (data/loaders.py), so CI and the
    bench can run the transformer workload offline — the real dataset
    name with missing files still fails loudly."""
    rng = np.random.default_rng(seed)
    V = vocab_size
    bos, eos, oov = V + 1, V + 2, V + 3
    # Zipf-ish unigram table + a sparse global successor table: each
    # word has 8 likely successors; a client remaps a seeded slice of
    # them, so clients share a language but not a distribution
    ranks = np.arange(1, V + 1, dtype=np.float64)
    unigram = (ranks ** -1.1) / np.sum(ranks ** -1.1)
    succ = rng.integers(1, V + 1, (V, 8))

    def client_sentences(crng, n):
        bias = crng.integers(1, V + 1, 32)
        out = np.zeros((n, seq_len + 1), np.int32)
        out[:, 0] = bos
        lengths = crng.integers(seq_len // 2, seq_len + 1, n)
        word = crng.choice(V, size=n, p=unigram).astype(np.int64) + 1
        for t in range(seq_len):
            live = t < lengths
            nxt = succ[word - 1, crng.integers(0, 8, n)]
            # client bias: 25% of continuations come from the
            # client's own 32-word pool — the non-IID signal
            take_bias = crng.random(n) < 0.25
            nxt = np.where(take_bias, bias[crng.integers(0, 32, n)], nxt)
            # sprinkle oov like real tokenization does
            nxt = np.where(crng.random(n) < 0.02, oov, nxt)
            out[:, t + 1] = np.where(live, nxt, 0)
            # the Markov chain walks words only — an oov token leaves
            # the chain at its previous word
            word = np.where(live & (nxt <= V), nxt, word)
        # close short sentences with eos (position lengths[i] + 1)
        short = lengths < seq_len
        out[np.arange(n)[short], lengths[short] + 1] = eos
        return out

    train, test = [], []
    for c in range(num_clients):
        crng = np.random.default_rng((seed, c))
        n = int(crng.integers(sentences_low, sentences_high + 1))
        seqs = client_sentences(crng, n + max(2, n // 10))
        tr, te = seqs[:n], seqs[n:]
        train.append((tr[:, :-1], tr[:, 1:]))
        test.append((te[:, :-1], te[:, 1:]))
    x_tr, y_tr, tr_map = _natural_maps(train)
    x_te, y_te, te_map = _natural_maps(test)
    return FederatedData(
        x_tr, y_tr, x_te, y_te, tr_map, te_map, V + 4, "nwp"
    )


def load_stackoverflow_nwp(
    data_dir: str, vocab_size: int = 10000, seq_len: int = 20,
) -> FederatedData:
    """stackoverflow next-word prediction from the TFF h5 pair (reference
    ``stackoverflow_nwp/data_loader.py`` + ``dataset.py``:
    ``stackoverflow_train.h5`` / ``stackoverflow_test.h5``, group
    ``examples/<client_id>/tokens`` of utf-8 sentences, word vocabulary from
    ``stackoverflow.word_count``). x = tokens[:, :-1], y = tokens[:, 1:]
    (shifted LM targets over all positions, TFF's evaluation convention).
    A missing file raises: the seeded stand-in is the distinct dataset
    name ``synthetic_stackoverflow_nwp`` (data/loaders.py), never a
    substitute for a typo'd ``data_dir``."""
    wc = os.path.join(data_dir, "stackoverflow.word_count")
    train_p = os.path.join(data_dir, "stackoverflow_train.h5")
    test_p = os.path.join(data_dir, "stackoverflow_test.h5")
    _require(wc, "fake_stackoverflow_nwp")
    word_dict = _read_word_count(wc, vocab_size)

    def read_client(rows):
        seqs = stackoverflow_to_sequences(rows["tokens"], word_dict, seq_len)
        return seqs[:, :-1], seqs[:, 1:]

    return _build_text_federated(
        train_p,
        test_p,
        read_client,
        len(word_dict) + 4,
        "nwp",
        "fake_stackoverflow_nwp",
    )


def load_stackoverflow_lr(
    data_dir: str, vocab_size: int = 10000, tag_size: int = 500
) -> FederatedData:
    """stackoverflow tag prediction from the TFF h5 pair (reference
    ``stackoverflow_lr/data_loader.py`` + ``utils.py``): inputs = mean
    one-hot bag-of-words over the top-``vocab_size`` words
    (``preprocess_inputs``), targets = multi-hot over the top-``tag_size``
    tags from the ``stackoverflow.tag_count`` json
    (``preprocess_targets``)."""
    wc = os.path.join(data_dir, "stackoverflow.word_count")
    tc = os.path.join(data_dir, "stackoverflow.tag_count")
    _require(wc, "fake_stackoverflow_lr")
    _require(tc, "fake_stackoverflow_lr")
    word_dict = _read_word_count(wc, vocab_size)
    with open(tc) as f:
        tag_dict = {
            t: i for i, t in enumerate(list(json.load(f).keys())[:tag_size])
        }

    def bag_of_words(sens):
        x = np.zeros((len(sens), len(word_dict)), np.float32)
        for i, sen in enumerate(sens):
            words = sen.split(" ")
            n = len(words)
            if n == 0:
                continue
            for w in words:
                j = word_dict.get(w)
                if j is not None:  # oov column is sliced off like reference
                    x[i, j] += 1.0
            x[i] /= n  # mean over tokens INCLUDING oov hits
        return x

    def multi_hot_tags(tags):
        y = np.zeros((len(tags), len(tag_dict)), np.float32)
        for i, tg in enumerate(tags):
            for t in tg.split("|"):
                j = tag_dict.get(t)
                if j is not None:
                    y[i, j] = 1.0
        return y

    def read_client(rows):
        return bag_of_words(rows["tokens"]), multi_hot_tags(rows["tags"])

    return _build_text_federated(
        os.path.join(data_dir, "stackoverflow_train.h5"),
        os.path.join(data_dir, "stackoverflow_test.h5"),
        read_client,
        len(tag_dict),
        "tag_prediction",
        "fake_stackoverflow_lr",
    )


# ---------------------------------------------------------------------------
# Edge-case (OOD-pool) backdoor attacks
# ---------------------------------------------------------------------------


class EdgeCasePool:
    """An out-of-distribution example pool used as backdoor ammunition
    (reference ``edge_case_examples/data_loader.py``: Southwest-airline
    CIFAR images labeled 'truck', ARDIS digits for EMNIST). ``x_train`` is
    mixed into attacker clients' data with ``target_label``; ``x_test``
    measures the targeted task."""

    def __init__(self, x_train: np.ndarray, x_test: np.ndarray,
                 target_label: int):
        self.x_train = np.asarray(x_train, np.float32)
        self.x_test = np.asarray(x_test, np.float32)
        self.target_label = int(target_label)


def load_southwest_pool(
    data_dir: str, target_label: int = 9
) -> EdgeCasePool:
    """The reference's Southwest-airline CIFAR pool
    (``southwest_images_new_{train,test}.pkl``: pickled uint8 image arrays;
    airplane -> labeled 'truck' (9), ``data_loader.py:346-371``)."""
    import pickle

    tr_p = os.path.join(data_dir, "southwest_images_new_train.pkl")
    te_p = os.path.join(data_dir, "southwest_images_new_test.pkl")
    _require(tr_p, None)
    _require(te_p, None)
    with open(tr_p, "rb") as f:
        x_tr = np.asarray(pickle.load(f))
    with open(te_p, "rb") as f:
        x_te = np.asarray(pickle.load(f))
    if x_tr.dtype == np.uint8:
        x_tr = x_tr.astype(np.float32) / 255.0
        x_te = x_te.astype(np.float32) / 255.0
    return EdgeCasePool(x_tr, x_te, target_label)


def make_procedural_edge_pool(
    like: FederatedData,
    n_train: int = 200,
    n_test: int = 100,
    target_label: int = 9,
    seed: int = 0,
) -> EdgeCasePool:
    """Offline stand-in for the curated pools: a coherent OOD mode — one
    fixed out-of-distribution prototype plus small noise, shaped like the
    task's inputs (the statistical role the Southwest/ARDIS images play:
    a tight cluster living off the data manifold)."""
    rng = np.random.default_rng(seed + 0xED6E)
    shape = like.x_train.shape[1:]
    proto = rng.normal(0.0, 1.0, shape).astype(np.float32) * 3.0
    gen = lambda n: proto[None] + rng.normal(
        0, 0.2, (n,) + shape
    ).astype(np.float32)
    return EdgeCasePool(gen(n_train), gen(n_test), target_label)


def make_edge_case_backdoor(
    data: FederatedData,
    pool: EdgeCasePool,
    attacker_clients: tuple[int, ...] = (0,),
    attack_case: str = "edge-case",
    poison_fraction: float = 0.5,
    seed: int = 0,
) -> tuple[FederatedData, np.ndarray, np.ndarray]:
    """Mix the pool into the attacker clients' local data (reference
    ``load_poisoned_dataset`` mixing, ``data_loader.py:372-402``):

    - ``edge-case``: replace ``poison_fraction`` of the attacker's samples
      with pool examples labeled ``target_label`` (pure edge-case poison +
      remaining clean points).
    - ``almost-edge-case``: same, but poison examples get small in-
      distribution noise added (the reference's p-percent variant).
    - ``normal-case``: attacker data stays clean in-distribution but
      ``poison_fraction`` of its labels flip to ``target_label``.

    Returns ``(poisoned_data, targeted_x, targeted_y)`` where the targeted
    test set is the pool's test split labeled ``target_label`` — attack
    success = accuracy on it (reference poisoned-task eval,
    ``fedavg_robust/FedAvgRobustAggregator.py:14-64``)."""
    assert attack_case in ("edge-case", "almost-edge-case", "normal-case")
    rng = np.random.default_rng(seed)
    x = data.x_train.copy()
    y = data.y_train.copy()
    for c in attacker_clients:
        idx = np.asarray(data.train_idx_map[c])
        n_poison = int(len(idx) * poison_fraction)
        if n_poison == 0:
            continue
        chosen = rng.choice(idx, n_poison, replace=False)
        if attack_case == "normal-case":
            y[chosen] = pool.target_label
            continue
        take = rng.choice(len(pool.x_train), n_poison)
        px = pool.x_train[take]
        if attack_case == "almost-edge-case":
            px = px + rng.normal(0, 0.05, px.shape).astype(np.float32)
        x[chosen] = px
        y[chosen] = pool.target_label
    poisoned = FederatedData(
        x, y, data.x_test, data.y_test, data.train_idx_map,
        data.test_idx_map, data.num_classes, data.task,
    )
    targeted_y = np.full(len(pool.x_test), pool.target_label, np.int32)
    return poisoned, pool.x_test, targeted_y
