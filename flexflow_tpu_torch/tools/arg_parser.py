"""Parse the framework's command-line flags and dump the resulting FFConfig
as JSON (port of bin/arg_parser.py; the debugging utility the reference
ships as bin/arg_parser — bin/arg_parser/arg_parser.cc parses FFConfig
flags and prints the fields).

Usage: python -m flexflow_tpu_torch.tools.arg_parser [any FFConfig flags...]
"""

import argparse
import dataclasses
import json
import sys

from flexflow_tpu_torch.local_execution.config import FFConfig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    FFConfig.add_args(p)
    cfg = FFConfig.from_args(p.parse_args(argv))
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
