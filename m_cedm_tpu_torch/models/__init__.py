from m_cedm_tpu_torch.kernels import DEVICE_OPS, Ops
from m_cedm_tpu_torch.models.adm_unet import AdmUNet, AdmUNetConfig


def build_backbone(hparams, ops: Ops = DEVICE_OPS):
    """Select the backbone by name prefix, as the reference does
    (`adm*` -> the ADM U-Net). Returns (module, config)."""
    name = hparams["name"]
    if name.startswith("adm"):
        cfg = AdmUNetConfig.from_hparams(hparams)
        return AdmUNet(cfg, ops), cfg
    raise NotImplementedError(
        f"backbone {name!r}: the DDPM U-Net is not ported yet (see ROADMAP.md)")
