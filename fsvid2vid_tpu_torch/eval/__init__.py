"""Quality metrics of the port: PSNR, SSIM, LPIPS and FID (eval/metrics.py)
and the InceptionV3 pool3 extractor of standard FID (eval/inception.py)."""
