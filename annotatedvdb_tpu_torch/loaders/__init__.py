from .vcf_loader import VcfLoader
from .vep_loader import VepLoader

__all__ = ["VcfLoader", "VepLoader"]
