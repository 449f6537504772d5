"""Standalone server pretraining loop (reference ``rawTrainerEngine``,
src/algorithms/retrieval_trainer.py:240-359).

Port of the JAX package's ``engine/pretrain.py``: n epochs over a caption
loader with the MC-soft criterion, periodic retrieval validation, best-rsum
and last checkpoints, and a per-epoch learning-rate step, on the port's
``ServerEngine`` and ``RetrievalEvaluator``. The loop is thin host Python,
like the federated round; a loader's ``images`` may already be device
tensors (``data.device_synth.DeviceImageBatches``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from creamfl_tpu_torch.engine.evaluator import RetrievalEvaluator
from creamfl_tpu_torch.engine.server import ServerEngine
from creamfl_tpu_torch.utils.logging import PythonLogger


class RawTrainer:
    """Pretrains a ServerEngine's PCME on a (public) caption dataset.

    ``seed`` seeds torch's generators (BERT dropout) when ``train`` starts,
    as the JAX trainer's key does."""

    def __init__(self, engine: ServerEngine, state, logger=None,
                 evaluator: Optional[RetrievalEvaluator] = None,
                 seed: int = 2021):
        self.engine = engine
        self.state = state
        self.logger = logger or PythonLogger()
        self.evaluator = evaluator or RetrievalEvaluator(
            n_crossfolds=0, logger=self.logger)
        self.seed = seed
        self.metadata: Dict = {}

    def _inputs(self, batch):
        return (batch["images"],) + tuple(self.engine.text_inputs(batch))

    def _train_epoch(self, loader, cur_epoch: int, prefix: str = "",
                     pub_data_ratio: float = 1.0) -> Dict:
        """One epoch; ``pub_data_ratio`` truncates like the reference's
        mid-epoch break (retrieval_trainer.py:251-252)."""
        n_batches = len(loader)
        stop_at = int(n_batches * pub_data_ratio)
        ldict = {}
        idx = 0
        for idx, batch in enumerate(loader):
            if pub_data_ratio < 1.0 and idx == stop_at:
                break
            self.state, ldict = self.engine.train_step(self.state,
                                                       *self._inputs(batch))
        report = {f"{prefix}{k}": float(v) for k, v in ldict.items()}
        report["step"] = cur_epoch + idx / max(1, n_batches)
        self.logger.report(cur_epoch, report)
        return report

    def _extract_eval(self, batch):
        return self.engine.eval_step(self.state, *self._inputs(batch))

    def evaluate(self, val_loaders: Dict) -> Dict:
        return {key: self.evaluator.evaluate(loader, self._extract_eval)
                for key, loader in val_loaders.items()}

    def train(self, tr_loader, n_epochs: int,
              val_loaders: Optional[Dict] = None, val_epochs: int = 1,
              model_save_to: str = "last.pth",
              best_model_save_to: str = "best.pth",
              pub_data_ratio: float = 1.0) -> Dict:
        if val_loaders is not None and "val" not in val_loaders:
            raise KeyError(
                f'val_loaders should contain key "val", '
                f'but ({list(val_loaders.keys())})')
        torch.manual_seed(self.seed)
        t0 = time.time()
        self.logger.log("start train")
        best_score = 0.0
        scores: Dict = {}
        for cur_epoch in range(n_epochs):
            self.state = self.engine.set_round_lr(self.state, cur_epoch)
            self._train_epoch(tr_loader, cur_epoch, prefix="train__",
                              pub_data_ratio=pub_data_ratio)
            metadata = dict(self.metadata)
            metadata["cur_epoch"] = cur_epoch + 1
            metadata["lr"] = float(self.engine.lr_schedule(cur_epoch))
            if val_loaders is not None and (
                    (cur_epoch + 1) % val_epochs == 0 or cur_epoch == 0):
                scores = self.evaluate(val_loaders)
                metadata["scores"] = scores["val"]
                if best_score < scores["val"]["rsum"]:
                    best_score = scores["val"]["rsum"]
                    metadata["best_score"] = best_score
                    metadata["best_epoch"] = cur_epoch + 1
                    self.engine.save_models(best_model_save_to,
                                            self.state, metadata)
                self.engine.report_scores(cur_epoch + 1, scores,
                                          metadata=metadata,
                                          logger=self.logger)
            self.engine.save_models(model_save_to, self.state, metadata)
            elapsed = time.time() - t0
            remain = elapsed / (cur_epoch + 1) * n_epochs - elapsed
            self.logger.log(f"expected remain {remain:.1f}s")
        self.logger.log(f"finish train, takes {time.time() - t0:.1f}s")
        return {"best_score": best_score, "scores": scores}
