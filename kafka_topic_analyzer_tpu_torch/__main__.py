"""``python -m kafka_topic_analyzer_tpu_torch``: the port's CLI."""

import sys

from kafka_topic_analyzer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
