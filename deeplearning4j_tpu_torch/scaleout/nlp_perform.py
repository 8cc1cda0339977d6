"""Counterpart of ``deeplearning4j_tpu/scaleout/nlp_perform.py``:
distributed NLP work performers, Word2Vec / GloVe on the scaleout runner.

Parity surface: the reference trains embeddings on the cluster through
WorkerPerformers in three transports —
- Akka: scaleout/perform/models/word2vec/Word2VecPerformer.java (skip-gram
  worker with exp table, shared lr decay via the tracker counter
  NUM_WORDS_SO_FAR) + Word2VecJobAggregator,
- Spark: dl4j-spark-nlp .../word2vec/Word2VecPerformer.java,
- YARN: hadoop/nlp models/{word2vec,glove} performers.

Workers keep full embedding matrices on their device (CUDA unless
``device="cpu"``) and ship them as a flat host vector; each job's pair
batch trains with the SAME steps the local models use (``_sgns_step`` /
``_glove_step``), and the standard ParameterAveragingAggregator averages
worker vectors per IterativeReduce round. The shared lr-decay counter
follows the reference's NUM_WORDS_SO_FAR pattern but counts skip-gram
PAIRS (the unit jobs are denominated in here); pass ``total_pairs``
accordingly (approx. 2 x window x corpus words). The mesh path
(``models.word2vec.make_sharded_sgns_step``) is the collective one; this
is the control-plane-parity path.

The Word2Vec performer splits its key once a job through ``ops.rng``, as
the JAX performer splits its own, and draws its negatives at
``models.word2vec._neg_slots``: tests put JAX's draws in at both points.
The initial tables are the shared numpy draws of ``InMemoryLookupTable``
and of ``np.random.default_rng(seed)``, the same in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.ops import rng
from deeplearning4j_tpu_torch.scaleout.job import Job, JobIterator
from deeplearning4j_tpu_torch.scaleout.perform import WorkerPerformer
from deeplearning4j_tpu_torch.text.vocab import VocabCache

NUM_PAIRS_SO_FAR = "num_pairs_so_far"  # ref pattern: Word2VecPerformer NUM_WORDS_SO_FAR (pair-denominated here)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Word2VecWorkPerformer(WorkerPerformer):
    """Skip-gram negative-sampling worker.

    Job.work = (centers, contexts) int arrays (one pair batch).
    Result = flat params: concat(syn0.ravel(), syn1neg.ravel()).
    update(flat) installs the averaged master vector.
    """

    def __init__(self, vocab: VocabCache, layer_size: int = 50,
                 negative: int = 5, lr: float = 0.025, min_lr: float = 1e-4,
                 total_pairs: Optional[int] = None, tracker=None,
                 seed: int = 123, device: DeviceLike = None):
        from deeplearning4j_tpu_torch.models.embeddings import \
            InMemoryLookupTable
        from deeplearning4j_tpu_torch.models.word2vec import (
            _sgns_step,
            build_neg_table,
        )

        self.device = resolve_device(device)
        self.vocab = vocab
        self.layer_size = layer_size
        self.negative = negative
        self.lr = lr
        self.min_lr = min_lr
        self.total_pairs = total_pairs
        self.tracker = tracker
        self._step = _sgns_step
        table = InMemoryLookupTable(vocab, layer_size, seed=seed,
                                    use_hs=False, negative=negative)
        self._syn0 = self._upload(table.syn0)
        self._syn1neg = self._upload(table.syn1neg)
        self._neg_table = build_neg_table(table.unigram_probs(),
                                          device=self.device)
        self._key = int(seed)
        self._pairs_local = 0

    def _upload(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(self.device)

    @property
    def vocab_size(self) -> int:
        return self.vocab.num_words()

    def _current_lr(self) -> float:
        """Linear decay by GLOBAL pairs seen — shared across workers via the
        tracker counter (ref pattern: Word2VecPerformer NUM_WORDS_SO_FAR;
        pair-denominated, matching the unit jobs carry)."""
        if self.total_pairs is None:
            return self.lr
        seen = (self.tracker.count(NUM_PAIRS_SO_FAR)
                if self.tracker is not None else self._pairs_local)
        frac = min(float(seen) / max(self.total_pairs, 1), 1.0)
        return max(self.min_lr, self.lr * (1.0 - frac))

    def perform(self, job: Job) -> None:
        centers, contexts = job.work
        dev = self.device
        centers = torch.from_numpy(np.asarray(centers, np.int64)).to(dev)
        contexts = torch.from_numpy(np.asarray(contexts, np.int64)).to(dev)
        weights = torch.ones(centers.shape[0], dtype=torch.float32,
                             device=dev)
        lr = float(np.float32(self._current_lr()))
        self._key, sub = rng.split(self._key)
        # the step trains the performer's own tables in place
        self._syn0, self._syn1neg, _ = self._step(
            self._syn0, self._syn1neg, centers, contexts, weights,
            self._neg_table, lr, sub, negative=self.negative)
        n = int(centers.shape[0])
        self._pairs_local += n
        if self.tracker is not None:
            self.tracker.increment(NUM_PAIRS_SO_FAR, n)
        job.result = np.concatenate([_host(self._syn0).ravel(),
                                     _host(self._syn1neg).ravel()])

    def update(self, *args) -> None:
        if not args:
            return
        flat = np.asarray(args[0], np.float32)
        v, d = self.vocab_size, self.layer_size
        self._syn0 = self._upload(flat[: v * d].reshape(v, d))
        self._syn1neg = self._upload(flat[v * d:].reshape(v, d))

    # query helpers for tests / model extraction
    def syn0(self) -> np.ndarray:
        return _host(self._syn0)


class GloveWorkPerformer(WorkerPerformer):
    """GloVe worker (ref: scaleout/perform/models/glove/GlovePerformer.java).

    Job.work = (rows, cols, logx, fx) arrays (one co-occurrence batch).
    Result = flat params: concat(w.ravel(), bias). AdaGrad accumulators stay
    worker-local (the reference averages parameter vectors only).
    """

    def __init__(self, vocab_size: int, layer_size: int = 50,
                 lr: float = 0.05, seed: int = 123,
                 device: DeviceLike = None):
        from deeplearning4j_tpu_torch.models.glove import _glove_step

        self.device = dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.layer_size = layer_size
        self.lr = lr
        self._step = _glove_step
        rng_ = np.random.default_rng(seed)
        self._w = torch.from_numpy(
            (rng_.random((vocab_size, layer_size), np.float32) - 0.5)
            / layer_size).to(dev)
        self._b = torch.zeros(vocab_size, dtype=torch.float32, device=dev)
        self._hw = torch.zeros(vocab_size, layer_size, dtype=torch.float32,
                               device=dev)
        self._hb = torch.zeros(vocab_size, dtype=torch.float32, device=dev)

    def perform(self, job: Job) -> None:
        rows, cols, logx, fx = job.work
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype)).to(dev)

        weights = torch.ones(len(rows), dtype=torch.float32, device=dev)
        self._w, self._b, self._hw, self._hb, _ = self._step(
            self._w, self._b, self._hw, self._hb,
            put(rows, np.int64), put(cols, np.int64),
            put(logx, np.float32), put(fx, np.float32), weights,
            float(np.float32(self.lr)))
        job.result = np.concatenate([_host(self._w).ravel(),
                                     _host(self._b)])

    def update(self, *args) -> None:
        if not args:
            return
        flat = np.asarray(args[0], np.float32)
        v, d = self.vocab_size, self.layer_size
        self._w = torch.from_numpy(
            np.array(flat[: v * d].reshape(v, d))).to(self.device)
        self._b = torch.from_numpy(np.array(flat[v * d:])).to(self.device)

    def syn0(self) -> np.ndarray:
        return _host(self._w)


class SkipGramJobIterator(JobIterator):
    """Slices a (centers, contexts) pair stream into fixed-size pair-batch
    jobs (the reference batches sentences into Word2VecWork jobs)."""

    def __init__(self, centers: np.ndarray, contexts: np.ndarray,
                 batch_size: int = 2048):
        self._c = np.asarray(centers, np.int32)
        self._t = np.asarray(contexts, np.int32)
        self._bsz = batch_size
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._c)

    def next(self, worker_id: str = "") -> Job:
        lo, hi = self._pos, min(self._pos + self._bsz, len(self._c))
        self._pos = hi
        return Job((self._c[lo:hi], self._t[lo:hi]), worker_id)

    def reset(self) -> None:
        self._pos = 0


class CoOccurrenceJobIterator(JobIterator):
    """Slices a GloVe co-occurrence list into fixed-size batch jobs."""

    def __init__(self, rows, cols, vals, x_max: float = 100.0,
                 alpha: float = 0.75, batch_size: int = 4096):
        self._rows = np.asarray(rows, np.int32)
        self._cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        self._logx = np.log(np.maximum(vals, 1e-12)).astype(np.float32)
        self._fx = np.minimum((vals / x_max) ** alpha, 1.0).astype(np.float32)
        self._bsz = batch_size
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._rows)

    def next(self, worker_id: str = "") -> Job:
        lo, hi = self._pos, min(self._pos + self._bsz, len(self._rows))
        self._pos = hi
        return Job((self._rows[lo:hi], self._cols[lo:hi],
                    self._logx[lo:hi], self._fx[lo:hi]), worker_id)

    def reset(self) -> None:
        self._pos = 0


class WordCountWorkPerformer(WorkerPerformer):
    """Distributed word counting (ref: scaleout/perform/text/
    WordCountWorkPerformer.java — each job is a chunk of sentences; the
    result is a token→count Counter the aggregator merges into the vocab).
    """

    def __init__(self, tokenizer_factory=None):
        from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory

        self.factory = tokenizer_factory or DefaultTokenizerFactory()

    def perform(self, job: Job) -> None:
        from deeplearning4j_tpu_torch.utils.counter import Counter

        counts = Counter()
        sentences = job.work if isinstance(job.work, (list, tuple)) else [job.work]
        for sentence in sentences:
            for tok in self.factory.create(sentence).get_tokens():
                counts.increment_count(tok, 1.0)
        job.result = counts

    def update(self, *args) -> None:  # stateless between jobs
        pass


class WordCountJobAggregator:
    """Merges per-job Counters (ref: scaleout/perform/text/
    WordCountJobAggregator — accumulate into one vocab count)."""

    def __init__(self):
        from deeplearning4j_tpu_torch.utils.counter import Counter

        self.counts = Counter()

    def accumulate(self, job: Job) -> None:
        if job.result is None:
            return
        for key in job.result.key_set():
            self.counts.increment_count(key, job.result.get_count(key))

    def aggregate(self):
        return self.counts
