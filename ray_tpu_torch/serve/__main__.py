import sys

from .scripts import main

sys.exit(main())
