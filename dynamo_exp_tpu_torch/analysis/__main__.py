"""``python -m dynamo_exp_tpu_torch.analysis``: dynlint over the port's
tree, pure stdlib (it runs with no torch installed). ``llmctl lint``
exposes the same flags on the operator CLI."""

import sys

from .runner import main

if __name__ == "__main__":
    sys.exit(main())
