#!/usr/bin/env python
"""Draw a waterfilling solution as TikZ LaTeX code, on the PyTorch port.

The counterpart of ``apps/waterfilling_tikz_draw.py``: ``gen_latex_code``
renders the inverse channel gains as a staircase with the water level as a
dashed line over a filled "water" rectangle, and ``draw_wf`` writes the
standalone .tex document; both give the JAX app's text. ``main`` solves
the waterfilling on ``--device`` with the port's branch-free
``comm.waterfilling.doWF_jit``.

Run: ``python apps/waterfilling_tikz_draw_torch.py [--out texCode.tex]
[--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.comm import waterfilling  # noqa: E402

_DOC_TEMPLATE = r"""\documentclass[a4]{{report}}
\usepackage[english]{{babel}}
\usepackage[utf8]{{inputenc}}
\usepackage{{amsmath,amssymb}}
\usepackage{{tikz}}
\everymath{{\displaystyle}}
\begin{{document}}
\pgfdeclarelayer{{background}}
\pgfdeclarelayer{{foreground}}
\pgfsetlayers{{background,main,foreground}}
\begin{{tikzpicture}}[every node/.style={{scale=0.8}}]
  % axes
  \coordinate (origin) at (0,0);
  \def\YMax{{ {y_max} }}
  \def\XMax{{ {x_max} }}
  \draw[-latex,shorten <=-3mm] (origin) -- (0,\YMax)
      node[left]{{$\frac{{N_0}}{{|H_n|^2}}$}};
  \draw[-latex,shorten <=-3mm,shorten >=-1mm] (origin) -- (\XMax,0)
      node[below]{{Channel}};
  % water level
  \def\waterLevelCoord{{ {water_coord} }}
  \begin{{pgfonlayer}}{{background}}
    \fill[gray!30!white] (origin) rectangle (\XMax,\waterLevelCoord);
  \end{{pgfonlayer}}
  \begin{{pgfonlayer}}{{foreground}}
    \draw[dashed] (0,\waterLevelCoord) node[left]{{ {water_label:.4f} }}
        -- ++(\XMax,0);
  \end{{pgfonlayer}}
  % inverse channel gain staircase
  \def\channelLength{{ {channel_length_mm}mm }}
  \draw[fill=white] (0,0)
  \foreach \ind/\value in {{ {points} }}
  {{
    -| (\ind*\channelLength,\value) coordinate (P\ind)
  }}
   -- ++(\channelLength,0) -- ++(0,-{last_point});
\end{{tikzpicture}}
\end{{document}}
"""


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gen_latex_code(vtChannels, waterLevel, noiseVar=1.0, channelLength=0.8):
    """LaTeX/TikZ code for the waterfilling picture of the channel power
    gains ``vtChannels`` (an array or a tensor) and ``waterLevel``."""
    inv_channels = float(noiseVar) / np.squeeze(_host(vtChannels))
    num_channels = inv_channels.size
    max_y = 3.0  # drawing height of the tallest feature, in cm
    y_scale_ref = max(float(np.max(inv_channels)), float(waterLevel))
    scaled = max_y * inv_channels / y_scale_ref
    points = ",".join(f"{i}/{scaled[i]}" for i in range(num_channels))
    return _DOC_TEMPLATE.format(
        x_max=num_channels * channelLength + 0.2,
        y_max=max_y + 0.2,
        water_coord=max_y * float(waterLevel) / y_scale_ref,
        water_label=float(waterLevel),
        channel_length_mm=int(round(channelLength * 10)),
        points=points,
        last_point=scaled[-1])


def draw_wf(vtChannels, waterLevel, noiseVar=1.0, channelLength=0.8,
            filename="texCode.tex"):
    """Write the TikZ document for a waterfilling solution to a file."""
    with open(filename, "w") as f:
        f.write(gen_latex_code(vtChannels, waterLevel, noiseVar,
                               channelLength))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="texCode.tex")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    dev = require_cuda(args.device)
    vtChannels = torch.tensor([9.32904521e-13, 2.63321084e-13,
                               5.06505202e-14], dtype=torch.float64,
                              device=dev)
    noiseVar = 2.5119e-14
    Pt = 0.2512
    vtOptP, mu = waterfilling.doWF_jit(vtChannels, Pt, noiseVar)
    print("Optimal powers:", _host(vtOptP), "(sum:", float(vtOptP.sum()), ")")
    print("Water level:", float(mu))
    draw_wf(vtChannels, float(mu), noiseVar, filename=args.out)
    print(f"Wrote TikZ code to {args.out}")


if __name__ == "__main__":
    main()
