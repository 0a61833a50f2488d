from .lof_loader import SnpEffLofLoader
from .qc_loader import QcPvcfLoader
from .txt_loader import TextLoader
from .update_loader import UpdateLoader, UpdateStrategy
from .vcf_loader import VcfLoader
from .vep_loader import VepLoader

__all__ = ["QcPvcfLoader", "SnpEffLofLoader", "TextLoader", "UpdateLoader",
           "UpdateStrategy", "VcfLoader", "VepLoader"]
