from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.models.adm_unet import AdmUNet, AdmUNetConfig
from m_cedm_tpu_torch.models.ddpm_unet import DdpmUNet, DdpmUNetConfig


def build_backbone(hparams, ops: Ops = DEVICE_OPS, mega: bool = False):
    """Select the backbone by name prefix, as the reference does
    (`adm*` -> the ADM U-Net, any other name -> the DDPM U-Net). Returns
    (module, config). `mega` selects the ADM U-Net's megakernel mode for its
    sampling path; the DDPM U-Net has none."""
    name = hparams["name"]
    if name.startswith("adm"):
        cfg = AdmUNetConfig.from_hparams(hparams)
        return AdmUNet(cfg, ops, mega=mega), cfg
    cfg = DdpmUNetConfig.from_hparams(hparams)
    return DdpmUNet(cfg, ops), cfg
