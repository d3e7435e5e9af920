"""Architecture registry: the paper's seven CNNs (Table 2)."""

from .paper_cnns import PAPER_CNNS
