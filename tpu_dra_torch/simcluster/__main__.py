from tpu_dra_torch.simcluster.cluster import main

if __name__ == "__main__":
    raise SystemExit(main())
