"""The heat-equation demo (heat, heat_cli) and its BMP converter (bmp,
bmp_cli), ported from lam_tpu/apps."""
