from splashsurf_tpu_torch.cli import main

main()
