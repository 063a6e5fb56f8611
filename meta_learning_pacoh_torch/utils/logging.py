"""Singleton logger (reference: meta_learn/util.py:60-92)."""

import logging
import os

_LOGGER_NAME = "pacoh-torch"


def get_logger(log_dir=None, log_file="output.log", expname=""):
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(logging.INFO)

    if not logger.handlers:
        prefix = f" {expname} - " if expname else ""
        formatter = logging.Formatter(
            "[%(asctime)s -" + prefix + "%(levelname)s]  %(message)s"
        )
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        sh.setLevel(logging.INFO)
        logger.addHandler(sh)
        logger.propagate = False

        if log_dir:
            fh = logging.FileHandler(os.path.join(log_dir, log_file))
            fh.setFormatter(formatter)
            fh.setLevel(logging.INFO)
            logger.addHandler(fh)
    return logger
