import sys

from distributed_membership_tpu_torch.runtime.application import main

sys.exit(main())
