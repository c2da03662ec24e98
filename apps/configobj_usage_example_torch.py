#!/usr/bin/env python
"""Config-file usage example, on the PyTorch port.

The counterpart of ``apps/configobj_usage_example.py``: parse an
INI-style simulation config against an inline spec (with the custom
``real_numpy_array`` range-expression validation), filling defaults and
writing the validated file back, through the port's standalone validator
(``pyphysim_tpu_torch/simulations/configobjvalidation.py``; the
``configobj`` package is not needed). Last, the validated SNR sweep is
put on ``--device`` as the simulation would use it.

Run: ``python apps/configobj_usage_example_torch.py [config_file]
[--device cuda]``.
"""

import argparse
import os
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.simulations.configobjvalidation import (  # noqa: E402
    load_config)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402

SPEC = """[Scenario]
SNR=real_numpy_array(default=15)
modulator=option('PSK', 'QAM', 'BPSK', default="PSK")
M=integer(min=4, max=512, default=4)
NSymbs=integer(min=10, max=1000000, default=200)
K=integer(min=2,default=3)
Nr=integer(min=2,default=2)
Nt=integer(min=2,default=2)
Ns=integer(min=1,default=1)
[IA Algorithm]
max_iterations=integer(min=1, default=60)
[General]
rep_max=integer(min=1, default=2000)
max_bit_errors=integer(min=1, default=3000)
unpacked_parameters=string_list(default=list('SNR'))
"""


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config_file", nargs="?",
                        default="psk_simulation_config.txt")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = require_cuda(args.device)
    config_file_name = args.config_file

    if not os.path.exists(config_file_name):
        # write a small config exercising the range-expression syntax
        with open(config_file_name, "w") as f:
            f.write("[Scenario]\nSNR=0:5:31\nM=16\nmodulator=QAM\n")
        print(f"Wrote example config to {config_file_name}")

    # save_parsed_file=True writes the file back with defaults filled in,
    # like configobj's validate(copy=True) + write()
    conf = load_config(config_file_name, SPEC, save_parsed_file=True)

    # load_config returns a SimulationParameters with all sections
    # flattened and the sweep axes already marked for unpacking
    print("Validated parameters:")
    for name in sorted(conf):
        print(f"  {name} = {conf[name]!r}")
    print("Unpacked (sweep) parameters:", conf.unpacked_parameters)
    print("Number of variations:", conf.get_num_unpacked_variations())
    snr = torch.as_tensor(conf["SNR"], dtype=torch.float64, device=dev)
    print(f"Linear SNRs on {dev}:", dB2Linear(snr).tolist())
    return conf


if __name__ == "__main__":
    main()
