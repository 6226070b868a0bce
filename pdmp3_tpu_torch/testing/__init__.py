"""Test-support utilities: synthetic MPEG-1/2/2.5 Layer III stream
generation (``mp3gen``)."""
