"""Serving: batch inference and its CLI (``deployment``), the result store,
the work queue, the REST backend, the queue worker, the TikTok client and
the crawler. Importing the package imports no torch: the serving CLI's
spawned decode workers import ``deployment`` as their main module."""

from vct_torch.serve.deployment import (  # noqa: F401
    classify_and_display,
    classify_videos,
    construct_url,
    load_model,
    post_results,
)
from vct_torch.serve.queue import QueuePull, QueuePush  # noqa: F401
from vct_torch.serve.store import ResultStore  # noqa: F401
