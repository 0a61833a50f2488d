from .vcf_loader import VcfLoader

__all__ = ["VcfLoader"]
