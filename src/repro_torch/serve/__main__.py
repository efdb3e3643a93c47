"""``python -m repro_torch.serve --smoke [--device cpu]``: the two-boot
serve smoke (see ``loadgen``)."""

from repro_torch.serve.loadgen import main

raise SystemExit(main())
