"""Host C++ of the port, built with g++ on first use (``build.py``)."""
