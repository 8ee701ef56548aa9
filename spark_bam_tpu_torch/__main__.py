import sys

from spark_bam_tpu_torch.cli import main

sys.exit(main())
