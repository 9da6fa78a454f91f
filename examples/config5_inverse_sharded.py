#!/usr/bin/env python
"""BASELINE config 5: differentiable inverse rendering — optimize material
parameters against a target render, sharded across the device mesh with
mean-reduced gradients.  (Across hosts the same script scales via
parallel.distributed.initialize; here it runs on whatever devices exist.)
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

from _common import setup_jax, small

jax = setup_jax()

import train  # the repo's inverse-rendering driver


def main():
    if small():
        args = ["--steps=20", "--w=12", "--h=12", "--samples=4"]
    else:
        args = ["--steps=100", "--w=32", "--h=32", "--samples=16"]
    return train.main(args)


if __name__ == "__main__":
    raise SystemExit(main())
