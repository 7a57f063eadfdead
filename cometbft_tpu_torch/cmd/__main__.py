from cometbft_tpu_torch.cmd.main import main

if __name__ == "__main__":
    raise SystemExit(main())
