"""The port's command-line entry points, one module each:
``python -m hydragen_torch.scripts.<name> --help``. Each runs on the card
unless given ``--device cpu``; ``main(argv)`` runs one in-process."""
