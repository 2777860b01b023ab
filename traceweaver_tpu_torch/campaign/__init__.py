"""Campaign artifacts: the ledger and the regression gate (mirrors
``traceweaver_tpu/campaign``, its ``ledger`` and ``compare`` modules).

- :mod:`~traceweaver_tpu_torch.campaign.ledger`: the ``CAMPAIGN_*.json``
  artifact, the ``tw_campaign_*`` ``/metrics`` mirror and the
  ``kind="campaign"`` events;
- :mod:`~traceweaver_tpu_torch.campaign.compare`: the regression gate
  between two artifacts.

The artifact has the JAX package's shape, so either package's
``compare`` reads the other's. The corpus ladder, the plan and the
runner (``campaign/corpus.py``, ``plan.py``, ``runner.py``) are not
ported yet; the wire campaign of the replica fleet
(:mod:`traceweaver_tpu_torch.fleet_serve.campaign`) writes its artifact
through this ledger.
"""

from traceweaver_tpu_torch.campaign.compare import (  # noqa: F401
    compare_artifacts,
    compare_paths,
    format_compare,
    format_report,
)
from traceweaver_tpu_torch.campaign.ledger import (  # noqa: F401
    load_artifact,
    write_artifact,
)
