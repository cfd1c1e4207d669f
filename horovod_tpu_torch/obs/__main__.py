import sys

from .cli import run_commandline

if __name__ == "__main__":
    sys.exit(run_commandline())
