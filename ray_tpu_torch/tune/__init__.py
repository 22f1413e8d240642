"""ray_tpu_torch.tune — hyperparameter search over the actor runtime
(counterpart of ``ray_tpu/tune/__init__.py``).

Analogue of Ray Tune (reference: python/ray/tune/ — Tuner, TuneController
execution/tune_controller.py:68, search spaces search/sample.py, ASHA
schedulers/async_hyperband.py), minimum slice: function trainables report
per-iteration metrics; the controller runs trials as actors up to a
concurrency cap; ASHA stops under-performers at rungs.

    from ray_tpu_torch import tune

    def objective(config):
        for _ in range(20):
            tune.report({"loss": (config["x"] - 3) ** 2})

    grid = tune.Tuner(objective,
                      param_space={"x": tune.uniform(0, 5)},
                      tune_config=tune.TuneConfig(metric="loss",
                                                  num_samples=8)).fit()
    best = grid.get_best_result()
"""

from ray_tpu_torch.tune.schedulers import (ASHAScheduler, BOHBScheduler,
                                           FIFOScheduler, PBTScheduler)
from ray_tpu_torch.tune.search import (BasicVariantGenerator, Searcher,
                                       choice, grid_search, loguniform,
                                       randint, uniform)
from ray_tpu_torch.tune.tpe import TPESearcher
from ray_tpu_torch.tune.trial import get_checkpoint, report
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig,
                                      Tuner)

__all__ = [
    "ASHAScheduler", "BOHBScheduler", "BasicVariantGenerator",
    "FIFOScheduler",
    "PBTScheduler", "ResultGrid", "Searcher", "TPESearcher", "TrialResult",
    "TuneConfig", "Tuner", "choice", "get_checkpoint", "grid_search",
    "loguniform", "randint", "report", "uniform",
]
